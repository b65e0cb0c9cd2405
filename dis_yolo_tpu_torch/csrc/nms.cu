// Class-aware greedy NMS over a score-sorted shortlist: kernel K2.
//
// Replaces the Pallas TPU kernel dis_yolo_tpu/ops/pallas_nms.py
// (_nms_kernel via nms_pallas).  The TPU kernel builds the whole K x K
// same-class `IoU > thr` matrix in VMEM and then runs max_det rounds of
// "argmax over the alive scores, lowest index on ties; stop when the best
// is not > -inf; clear the winner and its row".  Greedy NMS only ever
// reads the winners' rows, so this kernel never builds the matrix: each
// round tests the winner against the candidates still alive.
//
// Bound on an H100 SXM: at most max_det * K pair tests of ~15 float32
// operations plus K per round (0.26 MFLOP at K=512, max_det=30: ~4 ns at
// 67 TFLOP/s), 25 B read per candidate (~4 ns at 3.35 TB/s).  Far below
// one launch: the kernel is a chain of max_det dependent selections on one
// SM per image, so what it pays is each selection's latency.  The design
// keeps that chain short:
//   * one block per image, roundup(K, 32) threads; thread t owns
//     candidate t and keeps its box, area, class, score and alive bit in
//     registers; shared memory holds the winners (sorted route) or the
//     candidates' boxes, areas and classes (general route);
//   * sorted route, the main path's (the shortlist is a stable descending
//     sort): the prologue checks that the live scores (`valid && score >
//     -inf ? score : -inf`) do not rise with the index, with one
//     __syncthreads_or.  The argmax with the lowest index on ties is then
//     the lowest alive index, and greedy NMS is a scan in index order,
//     which the warps run in turn, with no block barrier: the warp that
//     holds the turn takes its lowest alive candidate as the next winner,
//     appends it (box, area, class, index) to a list in shared memory and
//     publishes the list's length with a release store, tests its other
//     candidates against it, and repeats until its 32 candidates are all
//     won or suppressed; then it passes the turn to the next warp with a
//     release store.  The waiting warps test their alive candidates
//     against each winner as soon as an acquire load shows it published,
//     so a warp has done most of its tests by the time its turn comes.
//     The output is written once, at the end;
//   * general route, any other input: max_det rounds of a block argmax
//     (warp shuffles, one partial per warp, double-buffered so that a
//     round needs one barrier), each followed by every alive same-class
//     candidate's test against the winner, read from shared memory;
//   * a valid candidate with a NaN score ends the selection before round 0
//     (all -1), as the TPU kernel's and the reference's argmax do; a
//     candidate with a -inf score is never picked, so it starts dead;
//   * when nothing is alive, the rest of the output is -1.
//
// IoU follows the TPU kernel's formula to the bit: inter = max(ix2-ix1,0)
// * max(iy2-iy1,0), union = (a_i + a_j) - inter, 0 where union <= 0, no
// FMA contraction (-fmad=false), and `iou > thr` decided on the IEEE
// quotient __fdiv_rn(inter, union); it is a knife edge, so one ULP would
// change the keep set.  Boxes that do not overlap (inter == 0, most pairs)
// skip the division: their quotient is exactly +0, and a zero dividend
// would send __fdiv_rn down its slow path, on the round's critical path.
// The shared-memory addresses are computed once and kept in registers,
// so a loop does not re-read special registers to rebuild them.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxK = 1024;
constexpr unsigned int kAll = 0xffffffffu;

struct Best {
  float s;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.s > a.s || (b.s == a.s && b.i < a.i)) ? b : a;
}

// the best of the warp, in every lane
__device__ __forceinline__ Best warp_best(Best best) {
  for (int off = 16; off > 0; off >>= 1) {
    Best other;
    other.s = __shfl_xor_sync(kAll, best.s, off);
    other.i = __shfl_xor_sync(kAll, best.i, off);
    best = better(best, other);
  }
  return best;
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
  if (inter == 0.0f) return 0.0f > thr;        // __fdiv_rn(0, uni) == +0
  return __fdiv_rn(inter, uni) > thr;
}

// shared memory through 32-bit addresses held in registers
__device__ __forceinline__ unsigned int shared_address(const void* p) {
  unsigned int a = (unsigned int)__cvta_generic_to_shared(p);
  asm volatile("" : "+r"(a));               // keep it: no recomputation
  return a;
}

__device__ __forceinline__ unsigned int load_shared_u32(unsigned int a) {
  unsigned int v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void store_shared_u32(unsigned int a,
                                                 unsigned int v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned int load_acquire_u32(unsigned int a) {
  unsigned int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release_u32(unsigned int a,
                                                  unsigned int v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ void store_shared_f4(unsigned int a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 load_shared_f4(unsigned int a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// the score a candidate competes with: -inf once it cannot be picked
__device__ __forceinline__ float live_score(float s, unsigned char v) {
  return (v != 0 && s > -INFINITY) ? s : -INFINITY;
}

__global__ void __launch_bounds__(kMaxK)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           const int* __restrict__ classes,
           const unsigned char* __restrict__ valid, long long* __restrict__ out,
           int k, int max_det, float thr, int force_general) {
  // general route: the candidates' boxes, areas and classes; sorted route:
  // the list of winners (at most min(K, max_det) of 32 B each)
  extern __shared__ float4 smem[];
  float4* sbox = smem;                                  // [k]
  float* sarea = reinterpret_cast<float*>(sbox + k);    // [k]
  int* scls = reinterpret_cast<int*>(sarea + k);        // [k]
  __shared__ Best partial[2][32];
  __shared__ int picks[kMaxK];              // general route's winners
  __shared__ unsigned int turn, n_won;

  const int b = blockIdx.x;
  int tid = threadIdx.x;
  asm volatile("" : "+r"(tid));             // keep it: no re-read
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  boxes += (size_t)b * k;
  scores += (size_t)b * k;
  classes += (size_t)b * k;
  valid += (size_t)b * k;
  out += (size_t)b * max_det;

  float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float area = 0.0f, score = -INFINITY;
  int cls = 0;
  bool nan_valid = false, unsorted = false;
  if (tid < k) {
    box = boxes[tid];
    area = area_of(box);
    cls = classes[tid];
    const float s = scores[tid];
    const unsigned char v = valid[tid];
    nan_valid = v != 0 && isnan(s);
    score = live_score(s, v);
    if (tid + 1 < k)
      unsorted = !(score >= live_score(scores[tid + 1], valid[tid + 1]));
  }
  bool alive = score > -INFINITY;
  if (tid == 0) {
    turn = 0u;
    n_won = 0u;
  }
  if (__syncthreads_or(nan_valid)) {
    // the argmax of round 0 is NaN: no round is ok
    for (int r = tid; r < max_det; r += nthreads) out[r] = -1LL;
    return;
  }
  const bool sorted = !__syncthreads_or(unsorted) && !force_general;

  if (sorted) {
    // winner e: box at list_at + 32 e, area at + 16, class at + 20,
    // candidate index at + 24
    const unsigned int list_at = shared_address(smem);
    const unsigned int turn_at = shared_address(&turn);
    const unsigned int won_at = shared_address(&n_won);
    const unsigned int most = (unsigned int)min(max_det, k);
    unsigned int tested = 0;        // winners this warp has tested against
    for (;;) {
      // every lane acquires the turn, then the list's length; the warp acts
      // on what all its lanes have seen
      const bool mine =
          __all_sync(kAll, load_acquire_u32(turn_at) == (unsigned int)warp);
      unsigned int won = __reduce_min_sync(kAll, load_acquire_u32(won_at));
      for (;;) {
        for (; tested < won; ++tested) {
          const unsigned int at = list_at + 32 * tested;
          if (alive && cls == (int)load_shared_u32(at + 20) &&
              iou_above(load_shared_f4(at),
                        __uint_as_float(load_shared_u32(at + 16)), box, area,
                        thr))
            alive = false;
        }
        if (!mine || won >= most) break;
        // this warp holds the turn and the list is complete up to its
        // lanes: its lowest alive candidate wins and writes itself to the
        // list; the loop above then tests the warp against it
        const unsigned int left = __ballot_sync(kAll, alive);
        if (left == 0u) break;
        if (lane == __ffs(left) - 1) {
          const unsigned int at = list_at + 32 * won;
          store_shared_f4(at, box);
          store_shared_u32(at + 16, __float_as_uint(area));
          store_shared_u32(at + 20, (unsigned int)cls);
          store_shared_u32(at + 24, (unsigned int)tid);
          alive = false;
        }
        __syncwarp();
        ++won;
        // publish it at once: the waiting warps test against it meanwhile
        if (lane == 0) store_release_u32(won_at, won);
      }
      if (mine) {
        // every winner of this warp is published: pass the turn
        if (lane == 0) store_release_u32(turn_at, (unsigned int)warp + 1);
        break;
      }
      if (won >= most) break;
    }
    // every warp has finished the scan (its turn passed or the list
    // full); the output is written once, here
    __syncthreads();
    const int n = (int)load_shared_u32(won_at);
    for (int r = tid; r < max_det; r += nthreads)
      out[r] = r < n ? (long long)load_shared_u32(list_at + 32 * r + 24) : -1LL;
    return;
  }

  if (tid < k) {
    sbox[tid] = box;
    sarea[tid] = area;
    scls[tid] = cls;
  }
  __syncthreads();
  const unsigned int box_at = shared_address(sbox);
  const unsigned int area_at = shared_address(sarea);
  const unsigned int cls_at = shared_address(scls);
  int cur = 0, n = 0;
  for (; n < max_det; ++n) {
    Best best = {alive ? score : -INFINITY, alive ? tid : INT_MAX};
    best = warp_best(best);
    if (lane == 0) partial[cur][warp] = best;
    __syncthreads();
    const Best none = {-INFINITY, INT_MAX};
    const Best all = warp_best(lane < nwarps ? partial[cur][lane] : none);
    cur ^= 1;
    if (!(all.s > -INFINITY)) break;      // nothing alive: no later round is ok
    const int j = all.i;
    if (tid == 0) picks[n] = j;
    const int cj = (int)load_shared_u32(cls_at + 4 * j);
    if (alive && (tid == j ||
                  (cls == cj &&
                   iou_above(load_shared_f4(box_at + 16 * j),
                             __uint_as_float(load_shared_u32(area_at + 4 * j)),
                             box, area, thr))))
      alive = false;
  }
  // n rounds were ok (every thread saw the same winners); written once
  __syncthreads();
  for (int r = tid; r < max_det; r += nthreads)
    out[r] = r < n ? (long long)picks[r] : -1LL;
}

}  // namespace

// dis_nms with force_general != 0: the general route even for sorted
// scores (chip_smoke.py checks and times both routes).
extern "C" int dis_nms_config(const float* boxes, const float* scores,
                              const int* classes, const unsigned char* valid,
                              long long* out, int batch, int k, int max_det,
                              float iou_thresh, int force_general,
                              void* stream) {
  if (k < 1 || k > kMaxK || max_det < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int threads = (k + 31) / 32 * 32;
  // the larger of the general route's candidates and the sorted route's
  // winners
  const size_t bytes = (size_t)k * 32;
  nms_kernel<<<batch, threads, bytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, classes, valid, out, k,
      max_det, iou_thresh, force_general);
  return (int)cudaGetLastError();
}

// boxes [B,K,4] f32 yxyx, scores [B,K] f32, classes [B,K] i32, valid [B,K]
// u8 -> out [B,max_det] i64 picked indices (-1 padded).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int dis_nms(const float* boxes, const float* scores,
                       const int* classes, const unsigned char* valid,
                       long long* out, int batch, int k, int max_det,
                       float iou_thresh, void* stream) {
  return dis_nms_config(boxes, scores, classes, valid, out, batch, k, max_det,
                        iou_thresh, 0, stream);
}
