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
// Bound on an H100 SXM (3.35 TB/s): pure data movement.  At B=2, R=10,
// S=288, k=3 it must write the dense gradient (6.0 MB) and read g only
// where a pixel lies in a ROI (g outside every ROI does not change the
// output): 4 bytes per (ROI, pixel inside it), up to 6.6 MB when every ROI
// covers the map.  So 6.0-12.6 MB, about 1.8-3.8 us, as the ROIs decide.
// The work is a few additions per pixel, so what keeps a kernel from that
// bound is instructions and latency, not bandwidth: per pixel it must not
// redo for every channel what only depends on the row or the column.
//
// Design.  The TPU carries one [k*k, S, S] accumulator across a sequential
// grid over the ROIs; Hopper blocks run in no order, so the loop is
// inverted and each thread owns one pixel and all k*k of its sums.  One
// block per (image b, row r, column segment of at most 96 pixels), one
// thread per pixel: at B=2, S=288 that is 1728 blocks of 96 threads, all
// resident at once.  Short blocks keep each block's chain (ROI tests,
// barrier, compaction, barrier, loads, sums, barrier, stores) short and
// spread the 6 MB of stores evenly over the SMs; whole-row blocks (576
// blocks of 288 threads) were slower on the card.
//   * The bins are separable.  R threads test each ROI against the block's
//     row segment and take its row bin once per block (grid lines with K1's arithmetic:
//     __fmul_rn/__fdiv_rn/__fadd_rn and rintf, built with -fmad=false),
//     and write its k+1 column grid lines to shared memory.  Warp 0
//     compacts the ROIs that meet the row and the segment, in ascending d,
//     with ballots.  A thread then only takes its own column bin per such
//     ROI: k-1 compares against lines every thread reads at one address.
//   * A block whose row segment no ROI meets writes zeros with 16-byte
//     stores and no bin math (the tiled TPU kernel's `intersects`).
//   * Otherwise each thread walks the row's ROIs in ascending d and, where
//     its pixel lies inside, adds g[b, d, r, c] (read only there,
//     coalesced along the row, kUnroll loads issued before they are used)
//     to the accumulator of its bin.  For k = 3, 5, 7 the k*k accumulators
//     are registers (compile-time k, the bin selected by unrolled
//     compares); for any other k up to 16 they are the thread's own slots
//     of the shared-memory staging row.
//   * The accumulators go through shared memory, so the block writes its
//     contiguous NHWC range [cols * k*k] with 16-byte stores; the staging
//     row is shifted to the range's alignment mod 16 bytes, so only a head
//     and a tail of at most 3 floats are scalar (S*k*k*4 not a multiple
//     of 16, e.g. S=97).
// The same additions happen in the same order (ascending d, from +0, only
// where the pixel lies in the ROI) as in the plain version
// (ops/mask_assembly.py: assemble_bwd_plain) and the TPU kernels, with no
// atomics, so the result is bit-exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxRois = 256;
constexpr int kSegCols = 96;           // pixels (threads) per block
constexpr int kMaxThreads = 128;       // kSegCols rounded up to warps
constexpr int kUnroll = 4;             // g loads in flight per thread
constexpr int kSmemBytes = 49152;      // the 48 KB default budget

// bin of pos between grid lines l[0..k] (half-open), -1 outside
template <int K>
__device__ __forceinline__ int bin_in(const float* l, int k_rt, float pos) {
  const int k = K > 0 ? K : k_rt;
  if (!(pos >= l[0] && pos < l[k])) return -1;
  int b = 0;
#pragma unroll
  for (int i = 1; i < k; ++i) b += (pos >= l[i]) ? 1 : 0;
  return b < k - 1 ? b : k - 1;
}

__device__ __forceinline__ float grid_line(float lo, float sub, int i) {
  return rintf(__fadd_rn(lo, __fmul_rn((float)i, sub)));
}

// write n floats of dst from stage[sh + e] (or zeros): 16-byte stores for
// the body; sh is dst's offset in floats past a 16-byte boundary
__device__ __forceinline__ void store_row(float* dst, const float* stage,
                                          int sh, int n, bool zero) {
  const int head = min((4 - sh) & 3, n);
  const int nv = (n - head) >> 2;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* s4 = reinterpret_cast<const float4*>(stage + sh + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int j = threadIdx.x; j < nv; j += blockDim.x) d4[j] = zero ? z : s4[j];
  for (int e = threadIdx.x; e < head; e += blockDim.x)
    dst[e] = zero ? 0.f : stage[sh + e];
  for (int e = head + 4 * nv + threadIdx.x; e < n; e += blockDim.x)
    dst[e] = zero ? 0.f : stage[sh + e];
}

// K > 0: compile-time k, accumulators in registers; K == 0: any k,
// accumulators in the staging row
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
assembly_bwd_kernel(const float* __restrict__ boxes, const float* __restrict__ g,
                    float* __restrict__ out, int n_roi, int size, int k_rt,
                    int cw) {
  const int k = K > 0 ? K : k_rt;
  const int kk = k * k;
  const int nl = k + 1;
  const int c0 = blockIdx.x * cw;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const int cols = min(cw, size - c0);
  const int tid = threadIdx.x;

  // stage [cw*kk + 4 rounded to 4] | lines [n_roi][k+1] | rbs [n_roi] |
  // act [n_roi] | n_act
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* lx = stage + ((cw * kk + 4 + 3) & ~3);
  int* rbs = reinterpret_cast<int*>(lx + n_roi * nl);
  int* act = rbs + n_roi;
  int* n_act_s = act + n_roi;

  const float fr = (float)r;
  const float fc0 = (float)c0, fc1 = (float)(c0 + cols);
  for (int d = tid; d < n_roi; d += blockDim.x) {
    const float* box = boxes + ((size_t)b * n_roi + d) * 4;
    const float y1 = box[0], x1 = box[1], y2 = box[2], x2 = box[3];
    int rb = -1;
    if (fr >= y1 && fr < y2 && x2 > fc0 && x1 < fc1) {
      const float sub_h = __fdiv_rn(__fsub_rn(y2, y1), (float)k);
      const float sub_w = __fdiv_rn(__fsub_rn(x2, x1), (float)k);
      int bb = 0;
      float* l = lx + d * nl;
      l[0] = x1;
      for (int i = 1; i < k; ++i) {
        bb += (fr >= grid_line(y1, sub_h, i)) ? 1 : 0;
        l[i] = grid_line(x1, sub_w, i);
      }
      l[k] = x2;
      rb = bb < k - 1 ? bb : k - 1;
    }
    rbs[d] = rb;
  }
  __syncthreads();
  if (tid < 32) {                        // ascending compaction, warp 0
    int base = 0;
    for (int d0 = 0; d0 < n_roi; d0 += 32) {
      const int d = d0 + tid;
      const int rb = d < n_roi ? rbs[d] : -1;
      const unsigned hit = __ballot_sync(0xffffffffu, rb >= 0);
      if (rb >= 0) act[base + __popc(hit & ((1u << tid) - 1))] = (d << 8) | rb;
      base += __popc(hit);
    }
    if (tid == 0) *n_act_s = base;
  }
  __syncthreads();
  const int n_act = *n_act_s;

  float* dst = out + (((size_t)b * size + r) * size + c0) * kk;
  const int sh = (int)(((uintptr_t)dst >> 2) & 3);
  if (n_act == 0) {                      // no ROI meets this row segment
    store_row(dst, stage, sh, cols * kk, true);
    return;
  }

  const bool valid = tid < cols;
  const int c = c0 + tid;
  const float fc = (float)c;
  const size_t plane = (size_t)size * size;
  const float* gp = g + (size_t)b * n_roi * plane + (size_t)r * size + c;
  float* mine = stage + sh + tid * kk;   // this pixel's k*k slots
  float acc[K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int q = 0; q < K * K; ++q) acc[q] = 0.f;
  } else if (valid) {
    for (int q = 0; q < kk; ++q) mine[q] = 0.f;
  }

  for (int i0 = 0; i0 < n_act; i0 += kUnroll) {
    float v[kUnroll];
    int cb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cb[u] = -1;
      v[u] = 0.f;
      if (valid && i0 + u < n_act) {
        const int d = act[i0 + u] >> 8;
        cb[u] = bin_in<K>(lx + d * nl, k, fc);
        if (cb[u] >= 0) v[u] = __ldg(gp + d * plane);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cb[u] < 0) continue;
      const int rb = act[i0 + u] & 0xff;
      if constexpr (K > 0) {
        // every index compile-time, so acc stays in registers
        const int q_hit = rb * K + cb[u];
#pragma unroll
        for (int q = 0; q < K * K; ++q)
          if (q == q_hit) acc[q] = __fadd_rn(acc[q], v[u]);
      } else {
        float* s = mine + rb * k + cb[u];
        *s = __fadd_rn(*s, v[u]);
      }
    }
  }
  if constexpr (K > 0) {
    if (valid) {
#pragma unroll
      for (int q = 0; q < K * K; ++q) mine[q] = acc[q];
    }
  }
  __syncthreads();
  store_row(dst, stage, sh, cols * kk, false);
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
  const int kk = k * k;
  // lines, row bins, the compacted list and its length
  const int fixed = (int)sizeof(float) * n_roi * (k + 1)
                    + (int)sizeof(int) * (2 * n_roi + 1);
  // widest column segment (a multiple of 8, at most kSegCols) whose
  // staging row fits beside them; at least 24 at k=16, R=256
  int cw = (kSmemBytes - fixed) / (4 * kk) - 2;
  cw = (cw < kSegCols ? cw : kSegCols) / 8 * 8;
  const int n_seg = (size + cw - 1) / cw;
  cw = (size + n_seg - 1) / n_seg;       // even segments
  const int threads = (cw + 31) / 32 * 32;
  const size_t smem = sizeof(float) * ((cw * kk + 4 + 3) & ~3) + fixed;
  const dim3 grid(n_seg, size, batch);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 3:
      assembly_bwd_kernel<3><<<grid, threads, smem, s>>>(boxes_px, g, out,
                                                         n_roi, size, k, cw);
      break;
    case 5:
      assembly_bwd_kernel<5><<<grid, threads, smem, s>>>(boxes_px, g, out,
                                                         n_roi, size, k, cw);
      break;
    case 7:
      assembly_bwd_kernel<7><<<grid, threads, smem, s>>>(boxes_px, g, out,
                                                         n_roi, size, k, cw);
      break;
    default:
      assembly_bwd_kernel<0><<<grid, threads, smem, s>>>(boxes_px, g, out,
                                                         n_roi, size, k, cw);
  }
  return (int)cudaGetLastError();
}
