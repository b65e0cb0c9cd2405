// Mask paste to the photo's pixels: kernel K5.
//
// Replaces no Pallas kernel: the JAX package pastes with XLA's dense
// products (dis_yolo_tpu/ops/paste.py), and so did the port until this
// kernel.  That route built two one-axis interpolation matrices per
// detection, [H0, S] and [W0, S], each row holding two bilinear taps, and
// ran two float32 GEMMs over all D rows of the batch, then `> 0.5`, the
// validity mask and a max over D for the semantic map: H0*S*(S + W0)
// multiply-adds a detection, padding rows included, and ~1-2 GB of float32
// temporaries.  The work is 4 taps a pixel inside each box; K5 does those
// alone and writes each output once.
//
// Inputs, all made by the shared PyTorch code of ops/paste.py (the tables
// of _axis_taps, the validity flags and the clamped class ids):
//   masks   [B,D,S,S] f32, K1's output;
//   i0, i1, w, inside   [B,D,2,L]: per axis (0 the photo's rows, 1 its
//           columns) and position, the absolute score-map indices of the
//           two taps (int32), the weight of tap 1 (f32) and whether the
//           position is inside the box (bool); L >= max(H0, W0);
//   valid   [B,D] bool; cls [B,D] int32 in [0, 255].
// Outputs: full [B,D,H0,W0] bool (one byte a pixel) and, when asked,
// sem [B,H0,W0] uint8: for each pixel the last detection whose bit is set
// paints cls + 1 (as uint8: class 255 wraps to 0), 0 where none is set.
//
// Exactness.  The bits must equal the dense route's cuBLAS products.
// Their SIMT float32 kernels (sm80_xmma_gemm_f32f32_*) accumulate each
// output with one FMA per k, in ascending k from 0, and a zero weight
// leaves the sum unchanged (checked on the card at the four serving
// shapes).  So with the axis weights formed as _axis_matrix forms them
// (a0 = 1 - w and a1 = w on two taps, one weight (1 - w) + w on coinciding
// taps), the row pass at a column c is fma(a1r, M[i1r,c], a0r * M[i0r,c]),
// or ar * M[i0r,c] on coinciding taps, and the column pass the same over
// the row pass's values at the two column taps.  Every step is written
// with the _rn intrinsics and the file is built with -fmad=false.
//
// Bound on an H100 SXM (3.35 TB/s): bytes written.  At B=8, D=30 and a
// 720 x 960 photo the outputs are 166 MB of booleans and 5.5 MB of
// semantic map, at least 51 us; the tables are 6 MB and the mask reads
// the crops' taps, mostly from L1 and L2.  What costs beside the stores is
// the latency of the reads inside the boxes.  The design:
//   * a warp owns kRows = 4 rows of a segment of kSeg = 128 columns of one
//     image, and loops over the D detections, so one pass writes every
//     mask row and keeps the semantic map of its pixels in registers;
//   * whether a row is inside a valid detection's box is the same for the
//     whole warp: a detection that misses all four rows costs one 4-byte
//     store of zeros per lane and row and no other read;
//   * inside the box the lanes take adjacent columns (lane l: columns
//     l, l + 32, l + 64, l + 96), so the tap and mask reads of a warp fall
//     on one or two cache lines; the segment's column taps and the rows'
//     taps are read once for the four rows, and 32 columns outside the box
//     are skipped; each 32 columns' bits come back as one ballot, and
//     every lane then holds the 4 consecutive pixels it stores with one
//     4-byte store, a warp's stores one 128-byte line;
//   * consecutive warps take consecutive rows of one segment, so they
//     share its column taps and neighbouring mask rows in L1.
// On an H100 80GB HBM3 at B=8, D=30 and the serving shapes, 4 columns and
// 4 rows a warp ran at 159-196 us, against 177-224 us for 8 columns x 4
// rows, 200-211 for 4 x 2 and 250-300 for a single row of 4 or of 16
// columns a lane; with every row invalid (stores of zeros alone) it takes
// 75-134 us, against 51 us for a fill of the same bytes.
// A row whose width is not a multiple of 4 takes the byte stores of the
// same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;             // columns a lane stores
constexpr int kRows = 4;             // rows a warp takes
constexpr int kSeg = 32 * kCols;     // columns a warp covers
constexpr unsigned kAll = 0xffffffffu;
constexpr int kWarps = 4;            // warps a block (64-512 threads ran
                                     // within 3% of each other)

struct PasteArgs {
  const float* masks;
  const int* i0;
  const int* i1;
  const float* w;
  const uint8_t* inside;
  const uint8_t* valid;
  const int* cls;
  uint8_t* full;
  uint8_t* sem;
  int n_det, size, out_h, out_w, len, segs, row_groups;
  long long units;                   // warps' work units
};

// the two weights of one output pixel's taps, as _axis_matrix forms them
__device__ __forceinline__ void tap_weights(int i0, int i1, float w,
                                            float& a0, float& a1) {
  const float omw = __fsub_rn(1.0f, w);
  a0 = i0 != i1 ? omw : __fadd_rn(omw, w);
  a1 = i0 != i1 ? w : 0.0f;
}

// one output of a product with one or two taps, summed as cuBLAS sums it
__device__ __forceinline__ float lerp2(float a0, float v0, float a1, float v1,
                                       bool two) {
  const float first = __fmul_rn(a0, v0);
  return two ? __fmaf_rn(a1, v1, first) : first;
}

// four bits -> four 0/1 bytes, bit e at byte e
__device__ __forceinline__ uint32_t spread4(unsigned bits) {
  return ((bits & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The bits of the rows of detection bd that its box holds (bit r of
// `rows` for row p0 + r): for each, the lane's 4 stored columns
// [base + 4 lane, base + 4 lane + 4), bit e for column e, in bits[r].
// Every lane of the warp calls it.
__device__ __forceinline__ void paste_rows(const PasteArgs& a, size_t bd,
                                           int p0, unsigned rows, int base,
                                           int lane, unsigned (&bits)[kRows]) {
  const int s = a.size;
  const size_t rb = bd * 2 * a.len, cb = rb + a.len;   // row, column tables
  unsigned in = 0, groups = 0;
  int j0[kCols], j1[kCols];
  float b0[kCols], b1[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    // columns past the row read its last column's taps, and paste nothing
    const int c = base + 32 * k + lane;
    const size_t cc = cb + min(c, a.out_w - 1);
    if (c < a.out_w && __ldg(a.inside + cc)) in |= 1u << k;
    j0[k] = __ldg(a.i0 + cc);
    j1[k] = __ldg(a.i1 + cc);
    tap_weights(j0[k], j1[k], __ldg(a.w + cc), b0[k], b1[k]);
  }
  int i0[kRows], i1[kRows];
  float a0[kRows], a1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    // rows past the photo read its last row's taps, and are not stored
    const size_t pr = rb + min(p0 + r, a.out_h - 1);
    i0[r] = __ldg(a.i0 + pr);
    i1[r] = __ldg(a.i1 + pr);
    tap_weights(i0[r], i1[r], __ldg(a.w + pr), a0[r], a1[r]);
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (__any_sync(kAll, (in >> k) & 1u)) groups |= 1u << k;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    bits[r] = 0;
    if (!((rows >> r) & 1u) || !groups) continue;
    const bool two = i0[r] != i1[r];
    const float* m0 = a.masks + (bd * s + i0[r]) * s;
    const float* m1 = a.masks + (bd * s + i1[r]) * s;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (!((groups >> k) & 1u)) continue;
      const float t0 =
          lerp2(a0[r], __ldg(m0 + j0[k]), a1[r], __ldg(m1 + j0[k]), two);
      const float t1 =
          lerp2(a0[r], __ldg(m0 + j1[k]), a1[r], __ldg(m1 + j1[k]), two);
      const bool bit = ((in >> k) & 1u) &&
                       lerp2(b0[k], t0, b1[k], t1, j0[k] != j1[k]) > 0.5f;
      const unsigned word = __ballot_sync(kAll, bit);
      // lane l stores columns 4 l .. 4 l + 3 of the segment: bits
      // 4 (l % 8) .. of group l / 8
      if (lane / 8 == k) bits[r] = (word >> (4 * (lane % 8))) & 0xFu;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps) paste_kernel(PasteArgs a) {
  const int lane = threadIdx.x;
  const long long unit = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (unit >= a.units) return;       // whole warps
  const int p0 = (int)(unit % a.row_groups) * kRows;
  const long long bs = unit / a.row_groups;
  const int base = (int)(bs % a.segs) * kSeg;
  const int b = (int)(bs / a.segs);
  const int n_rows = min(kRows, a.out_h - p0);
  const int c0 = base + kCols * lane;
  const int n_cols = max(0, min(kCols, a.out_w - c0));

  uint32_t sem[kRows] = {};          // the lane's 4 pixels of each row
  for (int g = 0; g < a.n_det; g += 32) {
    const int n = min(32, a.n_det - g);
    // the detections of this group whose box holds row p0 + r
    unsigned hit[kRows] = {};
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const size_t bd = (size_t)b * a.n_det + g + i;
      const unsigned v = __ldg(a.valid + bd);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < n_rows && (v & __ldg(a.inside + bd * 2 * a.len + p0 + r)))
          hit[r] |= 1u << i;
    }
    for (int i = 0; i < n; ++i) {
      const size_t bd = (size_t)b * a.n_det + g + i;
      unsigned rows = 0, bits[kRows] = {};
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows |= ((hit[r] >> i) & 1u) << r;
      if (rows) {
        paste_rows(a, bd, p0, rows, base, lane, bits);
        const uint32_t code = ((unsigned)(__ldg(a.cls + bd) + 1) & 0xFFu) *
                              0x01010101u;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const uint32_t m = spread4(bits[r]) * 0xFFu;
          sem[r] = (sem[r] & ~m) | (code & m);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= n_rows) break;
        uint8_t* out = a.full + (bd * a.out_h + p0 + r) * a.out_w + c0;
        if (kVec) {
          if (n_cols) *reinterpret_cast<uint32_t*>(out) = spread4(bits[r]);
        } else {
          for (int e = 0; e < n_cols; ++e)
            out[e] = (uint8_t)((bits[r] >> e) & 1u);
        }
      }
    }
  }

  if (a.sem == nullptr || !n_cols) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= n_rows) break;
    uint8_t* row = a.sem + ((size_t)b * a.out_h + p0 + r) * a.out_w + c0;
    if (kVec) {
      *reinterpret_cast<uint32_t*>(row) = sem[r];
    } else {
      for (int e = 0; e < n_cols; ++e) row[e] = (uint8_t)(sem[r] >> (8 * e));
    }
  }
}

}  // namespace

// masks [B,D,S,S] f32; i0, i1 [B,D,2,L] int32, w [B,D,2,L] f32, inside
// [B,D,2,L] bool (axis 0 rows, 1 columns; L >= H0, W0); valid [B,D] bool;
// cls [B,D] int32; full [B,D,H0,W0] bool; sem [B,H0,W0] uint8 or null;
// full and sem start on the 4-byte grid (the operator allocates them).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dis_paste_masks(
    const float* masks, const int* i0, const int* i1, const float* w,
    const uint8_t* inside, const uint8_t* valid, const int* cls,
    uint8_t* full, uint8_t* sem, int batch, int n_det, int size, int out_h,
    int out_w, int len, void* stream) {
  if (len < out_h || len < out_w) return (int)cudaErrorInvalidValue;
  if (batch == 0 || out_h == 0 || out_w == 0) return 0;
  const int segs = (out_w + kSeg - 1) / kSeg;
  const int row_groups = (out_h + kRows - 1) / kRows;
  const long long units = (long long)batch * row_groups * segs;
  const long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const PasteArgs a{masks, i0,    i1,   w,     inside, valid,      cls,
                    full,  sem,   n_det, size, out_h,  out_w,      len,
                    segs,  row_groups, units};
  // rows of a width that is a multiple of 4 start on the 4-byte grid
  const bool vec = out_w % kCols == 0;
  const dim3 block(32, kWarps);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    paste_kernel<true><<<(unsigned)blocks, block, 0, st>>>(a);
  else
    paste_kernel<false><<<(unsigned)blocks, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}
