// Position-sensitive mask assembly (+ sigmoid), forward: kernel K1.
//
// Replaces the Pallas TPU kernels of dis_yolo_tpu/ops/pallas_assembly.py
// (_assembly_kernel/_assemble_one/_bin_indicators, the resident layout, and
// _assembly_tiled_kernel, the row-tiled layout, both through _call_assembly).
// One kernel serves every score-map size S: the TPU needed two layouts for
// its 16 MB of VMEM, a Hopper block only needs a row tile of one box.
//
// For each image b and box d, the box is rounded to score-map pixels
// (round(norm * S), half to even) -- or, in pixel-box mode (the training
// forward, _assembly_px), taken as the already-rounded pixel box -- and
// split by the k+1 grid lines per axis g_i = round(y1 + i * (y2 - y1) / k)
// into k x k half-open bins.  Pixel (r, c) inside the box takes channel
// row_bin * k + col_bin of the NHWC [S, S, k*k] map (no transpose) -- or,
// in planes mode, of channel planes [k*k, S, S], the layout K4
// (extract.cu) writes -- as 1/(1+exp(-x)) (or the raw logit); every pixel
// outside is an exact 0.
//
// Bound on an H100 SXM (3.35 TB/s): the work is pure data movement.  At
// S=288, D=30, B=1 it reads the 3.0 MB score map once and writes 9.95 MB
// of masks: about 3.9 us.  Most of the output is zeros (a box covers a
// tenth of its mask on the main path), and the zeros alone run at the
// speed of a zero fill; what costs beside them is the serial chain of the
// blocks that meet a box (read the box, find the bins, gather, sigmoid,
// store).  The design keeps that chain short:
//   * a block is a tile of rows of one mask, ceil(S/4) threads across a
//     row and a few rows deep, small enough that nearly the whole grid is
//     resident at once;
//   * each thread owns 4 consecutive pixels of its rows and writes each
//     row's 4 with one 16-byte store; a row off the 16-byte grid (odd S)
//     has a scalar head and tail of at most 3 pixels each;
//   * tiles that the box misses (padding rows, zero boxes) and rows
//     outside it write 16-byte zeros with no bin math;
//   * no shared memory and no barrier: each thread of a tile that meets
//     the box takes the two bin sizes itself and computes each grid line
//     it compares with from its own expression; the bins are separable:
//     the row's bin once per row, the 4 columns' bins once (again only
//     when a row's 16-byte grid moves them, i.e. odd S), with no
//     per-pixel division or scan; the 4 pixels' loads are issued together.
//
// Exactness: the grid-line arithmetic uses __fmul_rn/__fdiv_rn/__fadd_rn
// and rintf, and the file is built with -fmad=false, so every rounding
// matches float32 on the CPU bit for bit; the logits are copies of score
// map values, so they are bit-exact too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxThreads = 1024;
// the default launch shape (chip_smoke.py's sweep): about this many
// threads per block, each covering this many rows of its tile
constexpr int kDefaultThreads = 256;
constexpr int kDefaultRowsPerThread = 1;

// interior grid line i of [lo, hi) in k bins, g_i = round(lo + i * sub)
__device__ __forceinline__ float grid_line(float lo, float sub, int i) {
  return rintf(__fadd_rn(lo, __fmul_rn((float)i, sub)));
}

// the bin of position pos in [lo, hi): the number of interior lines <= pos
__device__ __forceinline__ int bin_of(float pos, float lo, float sub, int k) {
  int n = 0;
  for (int i = 1; i < k; ++i) n += (pos >= grid_line(lo, sub, i)) ? 1 : 0;
  return n;
}

// the row's first pixels up to the 16-byte grid, and its whole 16-byte quads
__device__ __forceinline__ void row_split(const float* row, int size,
                                          int& head, int& quads) {
  const int off = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3u);
  head = min((4 - off) & 3, size);
  quads = (size - head) >> 2;
}

// column c of the row, in the order head, quads, tail: scalar slot e
__device__ __forceinline__ int scalar_column(int e, int head, int quads) {
  return e < head ? e : 4 * quads + e;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void zero_row(float* row, int size, int tx, int qx) {
  int head, quads;
  row_split(row, size, head, quads);
  float4* q4 = reinterpret_cast<float4*>(row + head);
  for (int q = tx; q < quads; q += qx) q4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tx; e < size - 4 * quads; e += qx)
    row[scalar_column(e, head, quads)] = 0.0f;
}

__global__ void __launch_bounds__(kMaxThreads)
assembly_kernel(const float* __restrict__ sm, const float* __restrict__ boxes,
                float* __restrict__ out, int n_box, int size, int k,
                int apply_sigmoid, int pixel_boxes, int planes,
                int rows_per_thread) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int qx = blockDim.x, ry = blockDim.y;
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * ry * rows_per_thread;
  const int row_end = min(row0 + ry * rows_per_thread, size);
  const float fs = (float)size;
  float* plane = out + ((size_t)b * n_box + d) * size * size;

  const float* box = boxes + ((size_t)b * n_box + d) * 4;
  float y1 = box[0], x1 = box[1], y2 = box[2], x2 = box[3];
  if (!pixel_boxes) {
    y1 = rintf(__fmul_rn(y1, fs));
    x1 = rintf(__fmul_rn(x1, fs));
    y2 = rintf(__fmul_rn(y2, fs));
    x2 = rintf(__fmul_rn(x2, fs));
  }
  // does any pixel of the tile lie inside the box? (padding rows never do)
  if (!(y2 > (float)row0 && y1 < (float)row_end && x2 > x1 && x2 > 0.0f &&
        x1 < fs)) {
    for (int r = row0 + ty; r < row_end; r += ry)
      zero_row(plane + (size_t)r * size, size, tx, qx);
    return;
  }

  const float sub_h = __fdiv_rn(__fsub_rn(y2, y1), (float)k);
  const float sub_w = __fdiv_rn(__fsub_rn(x2, x1), (float)k);
  const int kk = k * k;
  const float* src = sm + (size_t)b * size * size * kk;
  const size_t plane_stride = (size_t)size * size;
  int cached = -1;                 // first column of the bins below
  int cb[4] = {-1, -1, -1, -1};    // column bins, -1 outside [x1, x2)
  for (int r = row0 + ty; r < row_end; r += ry) {
    float* row = plane + (size_t)r * size;
    const float fr = (float)r;
    if (!(fr >= y1 && fr < y2)) {
      zero_row(row, size, tx, qx);
      continue;
    }
    const int rk = bin_of(fr, y1, sub_h, k) * k;
    // the row of the NHWC map, or of channel plane 0
    const float* src_row = planes ? src + (size_t)r * size
                                  : src + (size_t)r * size * kk;
    int head, quads;
    row_split(row, size, head, quads);
    for (int q = tx; q < quads; q += qx) {
      const int c0 = head + 4 * q;
      if (c0 != cached) {
        cached = c0;
        int n[4] = {0, 0, 0, 0};
        for (int g = 1; g < k; ++g) {
          const float line = grid_line(x1, sub_w, g);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            n[e] += ((float)(c0 + e) >= line) ? 1 : 0;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float fc = (float)(c0 + e);
          cb[e] = (fc >= x1 && fc < x2) ? n[e] : -1;
        }
      }
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = rk + cb[e];
        v[e] = cb[e] < 0 ? 0.0f
                         : (planes ? src_row[ch * plane_stride + c0 + e]
                                   : src_row[(size_t)(c0 + e) * kk + ch]);
      }
      if (apply_sigmoid) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (cb[e] >= 0) v[e] = sigmoid(v[e]);
      }
      reinterpret_cast<float4*>(row + c0)[0] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int e = tx; e < size - 4 * quads; e += qx) {
      const int c = scalar_column(e, head, quads);
      const float fc = (float)c;
      float v = 0.0f;
      if (fc >= x1 && fc < x2) {
        const int ch = rk + bin_of(fc, x1, sub_w, k);
        v = planes ? src_row[ch * plane_stride + c] : src_row[(size_t)c * kk + ch];
        if (apply_sigmoid) v = sigmoid(v);
      }
      row[c] = v;
    }
  }
}

}  // namespace

// dis_assemble_masks with the block shape chosen by the caller: about
// `threads` threads per block (ceil(S/4) across a row, as many rows deep
// as fit), each covering `rows_per_thread` rows of its tile.
// chip_smoke.py sweeps these; dis_assemble_masks runs the defaults.
extern "C" int dis_assemble_masks_config(const float* scoremaps,
                                         const float* boxes, float* out,
                                         int batch, int n_box, int size, int k,
                                         int apply_sigmoid, int pixel_boxes,
                                         int planes, int threads,
                                         int rows_per_thread, void* stream) {
  if (k < 1 || k > kMaxK || threads < 1 || rows_per_thread < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_box == 0 || size == 0) return 0;
  const int qx = std::min((size + 3) / 4, kMaxThreads);
  const int ry = std::max(1, std::min(std::min(threads, kMaxThreads) / qx, size));
  const int tile_rows = ry * rows_per_thread;
  const dim3 grid((size + tile_rows - 1) / tile_rows, n_box, batch);
  assembly_kernel<<<grid, dim3(qx, ry), 0, (cudaStream_t)stream>>>(
      scoremaps, boxes, out, n_box, size, k, apply_sigmoid, pixel_boxes,
      planes, rows_per_thread);
  return (int)cudaGetLastError();
}

// scoremaps [B,S,S,k*k] f32 (or [B,k*k,S,S] when planes != 0), boxes
// [B,D,4] f32 yxyx (normalized, or rounded score-map pixels when
// pixel_boxes != 0), out [B,D,S,S] f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dis_assemble_masks(const float* scoremaps,
                                  const float* boxes, float* out,
                                  int batch, int n_box, int size, int k,
                                  int apply_sigmoid, int pixel_boxes,
                                  int planes, void* stream) {
  return dis_assemble_masks_config(scoremaps, boxes, out, batch, n_box, size,
                                   k, apply_sigmoid, pixel_boxes, planes,
                                   kDefaultThreads, kDefaultRowsPerThread,
                                   stream);
}
