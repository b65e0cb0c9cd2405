// Position-sensitive mask assembly, backward: kernel K3.
//
// Replaces the Pallas TPU kernels of dis_yolo_tpu/ops/pallas_assembly.py
// behind the custom VJP of assemble_masks_trainable (_amt_bwd):
// _assembly_bwd_kernel, the resident layout, and _assembly_bwd_tiled_kernel,
// the row-tiled layout, both through _assembly_bwd.  It computes the
// gradient of the training forward's logits (K1 in pixel-box mode) with
// respect to the score maps:
//
//   dL/dsm[b, r, c, ky*k+kx] = sum_d g[b, d, r, c] * row_d[ky](r) * col_d[kx](c)
//
// for R rounded pixel boxes (ROIs) per image; the boxes get no gradient.
//
// Design.  The TPU carries one [k*k, S, S] accumulator across a sequential
// grid over the ROIs.  Hopper blocks run in no order, so the loop is
// inverted: one thread per output element (b, r, c, ch) of the NHWC
// [B, S, S, k*k] gradient walks the image's R ROIs in ascending d and adds
// g[b, d, r, c] where pixel (r, c) lies in ROI d and its bin is ch.  No
// atomics, and the additions happen in the TPU kernel's order starting from
// 0, so the result is bit-exact against the plain version
// (ops/mask_assembly.py: assemble_bwd_plain).  Per (image b, row tile t)
// block:
//   * R threads compute the ROIs' k+1 grid lines per axis into shared
//     memory with K1's arithmetic (__fmul_rn/__fdiv_rn/__fadd_rn, rintf,
//     built with -fmad=false), and whether each ROI's row span meets the
//     tile;
//   * a tile that no ROI's row span meets writes zeros with no bin math
//     (the tiled TPU kernel's `intersects`);
//   * otherwise consecutive threads take consecutive output elements, so
//     the stores are coalesced and the k*k threads of one pixel read the
//     same g value (one transaction), contiguous along the row.
//
// Bound on an H100 SXM (3.35 TB/s): pure data movement.  At B=2, R=10,
// S=288, k=3 it must write the dense gradient (6.0 MB) and read g only
// where a pixel lies in a ROI (g outside every ROI does not change the
// output): 4 bytes per (ROI, pixel inside it), up to 6.6 MB when every ROI
// covers the map.  So 6.0-12.6 MB, about 1.8-3.8 us, as the ROIs decide.
// The design reads g only inside a ROI, once per tile from L2/L1 for all
// k*k channels, and writes each output element once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxRois = 256;
constexpr int kThreads = 256;
constexpr int kTileRows = 2;

__device__ __forceinline__ int bin_of(const float* lines, int k, float pos) {
  int b = 0;
  for (int i = 1; i < k; ++i) b += (pos >= lines[i]) ? 1 : 0;
  return b < k - 1 ? b : k - 1;
}

__global__ void __launch_bounds__(kThreads)
assembly_bwd_kernel(const float* __restrict__ boxes, const float* __restrict__ g,
                    float* __restrict__ out, int n_roi, int size, int k) {
  // gy/gx: n_roi * (k+1) lines each; hit: n_roi flags
  extern __shared__ float smem[];
  const int nl = k + 1;
  float* gy = smem;
  float* gx = smem + n_roi * nl;
  int* hit = reinterpret_cast<int*>(smem + 2 * n_roi * nl);

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int kk = k * k;
  const int row0 = tile * kTileRows;
  const int rows = min(kTileRows, size - row0);

  int any = 0;
  if (threadIdx.x < n_roi) {
    const int d = threadIdx.x;
    const float* box = boxes + ((size_t)b * n_roi + d) * 4;
    const float y1 = box[0], x1 = box[1], y2 = box[2], x2 = box[3];
    const float sub_h = __fdiv_rn(__fsub_rn(y2, y1), (float)k);
    const float sub_w = __fdiv_rn(__fsub_rn(x2, x1), (float)k);
    float* ly = gy + d * nl;
    float* lx = gx + d * nl;
    ly[0] = y1;
    lx[0] = x1;
    for (int i = 1; i < k; ++i) {
      ly[i] = rintf(__fadd_rn(y1, __fmul_rn((float)i, sub_h)));
      lx[i] = rintf(__fadd_rn(x1, __fmul_rn((float)i, sub_w)));
    }
    ly[k] = y2;
    lx[k] = x2;
    any = (y2 > (float)row0 && y1 < (float)(row0 + rows)) ? 1 : 0;
    hit[d] = any;
  }
  any = __syncthreads_or(any);

  const int n_out = rows * size * kk;
  float* dst = out + ((size_t)b * size + row0) * size * kk;
  if (!any) {
    for (int p = threadIdx.x; p < n_out; p += kThreads) dst[p] = 0.0f;
    return;
  }

  const size_t plane = (size_t)size * size;
  const float* gb = g + (size_t)b * n_roi * plane;
  for (int p = threadIdx.x; p < n_out; p += kThreads) {
    const int ch = p % kk;
    const int pix = p / kk;
    const int r = row0 + pix / size;
    const int c = pix - (pix / size) * size;
    const float fr = (float)r, fc = (float)c;
    const size_t off = (size_t)r * size + c;
    float acc = 0.0f;
    for (int d = 0; d < n_roi; ++d) {
      if (!hit[d]) continue;
      const float* ly = gy + d * nl;
      const float* lx = gx + d * nl;
      if (fr >= ly[0] && fr < ly[k] && fc >= lx[0] && fc < lx[k] &&
          bin_of(ly, k, fr) * k + bin_of(lx, k, fc) == ch) {
        acc = __fadd_rn(acc, gb[d * plane + off]);
      }
    }
    dst[p] = acc;
  }
}

}  // namespace

// boxes_px [B,R,4] f32 yxyx rounded score-map pixels, g [B,R,S,S] f32,
// out [B,S,S,k*k] f32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int dis_assemble_bwd(const float* boxes_px, const float* g,
                                float* out, int batch, int n_roi, int size,
                                int k, void* stream) {
  if (k < 1 || k > kMaxK || n_roi < 0 || n_roi > kMaxRois)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || size == 0) return 0;
  if (n_roi == 0)
    return (int)cudaMemsetAsync(out, 0,
                                sizeof(float) * batch * size * size * k * k,
                                (cudaStream_t)stream);
  const size_t smem = sizeof(float) * 2 * n_roi * (k + 1) + sizeof(int) * n_roi;
  const dim3 grid((size + kTileRows - 1) / kTileRows, batch);
  assembly_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      boxes_px, g, out, n_roi, size, k);
  return (int)cudaGetLastError();
}
