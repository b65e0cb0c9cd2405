// Class-aware greedy NMS over a score-sorted shortlist: kernel K2.
//
// Replaces the Pallas TPU kernel dis_yolo_tpu/ops/pallas_nms.py
// (_nms_kernel via nms_pallas).  One block per image, one launch per batch:
//   1. the K x K same-class `IoU > thr` suppression matrix is built as a
//      bitmask in shared memory (K=512: 32 KB, K=1024: 128 KB, with the
//      boxes beside it; dynamic shared memory above 48 KB), never touching
//      device memory: one warp per 32-bit word, lanes on neighbouring
//      boxes, a ballot packs the word;
//   2. max_det rounds: a block-wide argmax over the alive scores, the
//      lowest index winning ties, then the winner's row is cleared from
//      the alive set.  Thread t owns candidate t (K <= 1024 threads), so a
//      round is two warp-shuffle reductions and two barriers.  Picked
//      indices come out -1 padded.
//
// IoU follows the TPU kernel's formula to the bit: inter = max(ix2-ix1,0)
// * max(iy2-iy1,0), union = (a_i + a_j) - inter, 0 where union <= 0, no
// FMA contraction (-fmad=false), and `iou > thr` decided on the IEEE
// quotient __fdiv_rn(inter, union); it is a knife edge, so one ULP would
// change the keep set.
//
// Bound on an H100 SXM: greedy NMS needs only the winners' rows, at most
// max_det * K pair tests of ~15 float32 operations each plus K per argmax
// round (0.26 MFLOP at K=512, max_det=30: ~4 ns at 67 TFLOP/s), and reads
// 25 B per candidate (~4 ns at 3.35 TB/s).  This kernel builds all K^2
// pairs instead (17x the work at K=512) on one SM per image, then runs
// max_det serial rounds, so it pays latency far above that bound.  Testing
// only the winners' rows, spread over SMs, is the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;

struct Best {
  float s;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.s > a.s || (b.s == a.s && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ float area_of(const float4 a) {
  // boxes are (y1, x1, y2, x2) in (x, y, z, w)
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// iou(a, b) > thr, with the IoU the TPU kernel computes, to the bit.
__device__ __forceinline__ bool iou_above(const float4 a, float area_a,
                                          const float4 b, float area_b,
                                          float thr) {
  const float iy1 = fmaxf(a.x, b.x);
  const float ix1 = fmaxf(a.y, b.y);
  const float iy2 = fminf(a.z, b.z);
  const float ix2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.0f)) return 0.0f > thr;        // the reference's IoU is 0
  return __fdiv_rn(inter, uni) > thr;
}

__device__ __forceinline__ Best warp_best(Best best) {
  for (int off = 16; off > 0; off >>= 1) {
    Best other;
    other.s = __shfl_down_sync(0xffffffffu, best.s, off);
    other.i = __shfl_down_sync(0xffffffffu, best.i, off);
    best = better(best, other);
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           const int* __restrict__ classes,
           const unsigned char* __restrict__ valid, long long* __restrict__ out,
           int k, int max_det, float thr) {
  extern __shared__ float4 smem[];
  const int words = (k + 31) / 32;
  float4* box = smem;                                         // [k], 16 B aligned
  unsigned int* sup = reinterpret_cast<unsigned int*>(box + k);  // [k][words]
  float* area = reinterpret_cast<float*>(sup + (size_t)k * words);
  int* cls = reinterpret_cast<int*>(area + k);
  __shared__ Best partial[kWarps];
  __shared__ int winner;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  boxes += (size_t)b * k;
  scores += (size_t)b * k;
  classes += (size_t)b * k;
  valid += (size_t)b * k;
  out += (size_t)b * max_det;

  // thread tid owns candidate tid (k <= kThreads) for the selection rounds
  const bool own = tid < k;
  const float my_score = own ? scores[tid] : -INFINITY;
  bool alive = own && valid[tid] != 0;
  if (own) {
    box[tid] = boxes[tid];
    area[tid] = area_of(box[tid]);
    cls[tid] = classes[tid];
  }
  __syncthreads();

  // one warp per bitmask word: lane l tests j = 32*w + l, so neighbouring
  // lanes read neighbouring boxes (no bank conflicts), and a ballot packs
  // the 32 answers into the word
  for (int i = warp; i < k; i += kWarps) {
    const float4 bi = box[i];
    const float ai = area[i];
    const int ci = cls[i];
#pragma unroll 4
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      const bool hit =
          j < k && cls[j] == ci && iou_above(bi, ai, box[j], area[j], thr);
      const unsigned int bits = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) sup[i * words + w] = bits;
    }
  }
  __syncthreads();

  for (int d = 0; d < max_det; ++d) {
    const Best mine = {alive ? my_score : -INFINITY, tid};
    const Best in_warp = warp_best(mine);
    if (lane == 0) partial[warp] = in_warp;
    __syncthreads();
    if (warp == 0) {
      const Best none = {-INFINITY, kThreads};
      const Best all = warp_best(lane < kWarps ? partial[lane] : none);
      if (lane == 0) {
        const bool ok = all.s > -INFINITY;
        winner = ok ? all.i : -1;
        out[d] = ok ? (long long)all.i : -1LL;
      }
    }
    __syncthreads();
    const int j = winner;
    if (j < 0) {
      // nothing alive: every later round is empty too
      for (int r = d + 1 + tid; r < max_det; r += kThreads) out[r] = -1LL;
      return;
    }
    if (alive && (tid == j || ((sup[j * words + warp] >> lane) & 1u)))
      alive = false;
  }
}

size_t smem_bytes(int k) {
  const size_t words = (size_t)(k + 31) / 32;
  return (size_t)k * words * 4 + (size_t)k * (16 + 4 + 4);
}

}  // namespace

// boxes [B,K,4] f32 yxyx, scores [B,K] f32, classes [B,K] i32, valid [B,K]
// u8 -> out [B,max_det] i64 picked indices (-1 padded).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dis_nms(const float* boxes, const float* scores,
                       const int* classes, const unsigned char* valid,
                       long long* out, int batch, int k, int max_det,
                       float iou_thresh, void* stream) {
  if (k < 1 || k > kMaxK || max_det < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const size_t bytes = smem_bytes(k);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  nms_kernel<<<batch, kThreads, bytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, classes, valid, out, k,
      max_det, iou_thresh);
  return (int)cudaGetLastError();
}
