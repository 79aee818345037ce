// Classic per-class greedy NMS over score-sorted top-k candidates.
//
// Replaces: watsor_tpu/ops/nms_pallas.py pallas_suppress
// (_pallas_suppress_impl, _suppress_kernel), the Pallas TPU kernel behind
// the `pallas` per-class NMS mode; the port's `exact` mode runs it too.
// Per (image, class), candidates come sorted by score; walking them in that
// order, a kept candidate retires every later candidate whose IoU with it
// exceeds the threshold. Output: the score where kept, else 0.
//
// What bounds it on the H100: neither bytes (20 bytes a candidate) nor
// operations (K(K-1)/2 IoUs, 4,950 at K = 100), but latency chains. The
// first version built the triangle with four warps, one IoU a lane at a
// time down a chain of about 370 cycles with one warp on each scheduler
// (77% of its time), then walked all K steps with a shuffle each (21%)
// (PERF.md, the first version's phase split).
//
// What the design does about it: one block of 16 warps per (image,
// class).
//  1. The boxes and their areas are staged in shared memory.
//  2. The triangle of the overlap relation (bit i of row j: i < j and
//     iou(i, j) > thr) is built one warp ballot per 32 candidates, every
//     warp taking every 16th row and all of a row's words at once, every
//     lane without a branch, so the warps' work is even and a lane's
//     chains overlap. The IoU's division is replaced by an exact test
//     (overlaps below).
//  3. One thread walks the candidates in score order with the kept mask in
//     registers: a step is a bit test of the candidate's row against it
//     and, for a kept candidate, one OR; no step waits on a load, and no
//     step shuffles.
//
// The IoU is rounded as the plain version (ops/boxes.py iou_matrix) rounds
// it, op by op, with the _rn intrinsics, so that nvcc contracts no multiply
// and add into an FMA: the surviving scores equal the plain version's bit
// for bit.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kMaxDevices = 64;

#ifdef WT_PHASE_CLOCK
// Development build only (python -m watsor_tpu_torch.profile_step --path
// nms): each block records %globaltimer and clock64 at its phase
// boundaries, the time of the last warp to reach each; wt_phase_stamps
// reads them back and clears them, wt_empty_kernel launches an empty
// kernel the same way, the card's floor for one launch.
constexpr int kStampBlocks = 1024;
constexpr int kStamps = 6;
__device__ unsigned long long g_stamps[kStampBlocks][2 * kStamps];

__device__ __forceinline__ void phase_stamp(int k) {
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if ((threadIdx.x & 31) != 0 || b >= kStampBlocks) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  atomicMax(&g_stamps[b][k], t);
  atomicMax(&g_stamps[b][kStamps + k], (unsigned long long)clock64());
}

__global__ void empty_kernel() {}
#define PHASE(k) phase_stamp(k)
#else
#define PHASE(k)
#endif

// shared memory of one block: the triangle, `words` words a row, then the
// boxes and their areas
size_t smem_bytes(int K, int words) {
  return (size_t)K * words * sizeof(uint32_t) +
         (size_t)K * (sizeof(float4) + sizeof(float));
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// The threshold test of iou_matrix's IoU, inter / max(union, 1e-8) > thr,
// without its division. The quotient q of two floats rounds to a float
// above thr exactly when q is above the midpoint of thr and the next float
// up, or on it and that float is even (round to nearest even). The
// midpoint has 25 significant bits, so its product with the divisor is
// exact in double: the test equals __fdiv_rn(inter, u) > thr bit for bit.
// Most pairs are far from the threshold, and a product in float decides
// them first: for a normal positive thr, fl(thr * u) is within 2^-24 of
// thr * u, and the midpoint times u within 2^-24 above it, so inter above
// fl(thr * u) (1 + 2^-20) is above the midpoint's product, and inter below
// fl(thr * u) (1 - 2^-20) below it. Where the double product is not finite
// (a threshold at the top of the float range, infinite boxes) the division
// decides.
struct Threshold {
  float thr;
  double mid;
  bool tie_up;  // a quotient on the midpoint rounds up
  bool quick;   // 1e-20 <= thr <= 1e20: the float test applies
};

__device__ __forceinline__ Threshold make_threshold(float thr) {
  const float up = nextafterf(thr, INFINITY);
  return {thr, 0.5 * ((double)thr + (double)up),
          (__float_as_uint(up) & 1u) == 0u,
          thr >= 1e-20f && thr <= 1e20f};
}

// iou_matrix of ops/boxes.py for one pair, op by op (boxes are (ymin,
// xmin, ymax, xmax)), against the threshold; symmetric bit for bit, since
// every step is
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, const Threshold& t) {
  const float inter =
      __fmul_rn(fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f),
                fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f));
  const float u = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-8f);
  if (t.quick) {
    const float p = __fmul_rn(t.thr, u);
    if (inter > __fmul_rn(p, 1.f + 0x1p-20f)) return true;
    if (inter < __fmul_rn(p, 1.f - 0x1p-20f)) return false;
  }
  const double bound = t.mid * (double)u;
  if (!isfinite(bound)) return __fdiv_rn(inter, u) > t.thr;
  const double q = (double)inter;
  return q > bound || (q == bound && t.tie_up);
}

// kWords: words of a triangle row, the least of 4, 8, 16, 32 with
// 32 * kWords >= K
template <int kWords>
__global__ void __launch_bounds__(kThreads)
    suppress_kernel(const float4* __restrict__ boxes,
                    const float* __restrict__ scores,
                    float* __restrict__ out, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* earlier = reinterpret_cast<uint32_t*>(smem);     // [K][kWords]
  float4* box = reinterpret_cast<float4*>(earlier + K * kWords);  // [K]
  float* area = reinterpret_cast<float*>(box + K);           // [K]
  __shared__ uint32_t kept_mask[kWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t set = blockIdx.x;  // one (image, class) candidate set
  PHASE(0);

  for (int j = threadIdx.x; j < K; j += kThreads) {
    const float4 b = boxes[set * K + j];
    box[j] = b;
    area[j] = box_area(b);
  }
  __syncthreads();
  PHASE(1);

  // earlier[j] bit i: i < j and iou(i, j) > thr (the triangle, stored by
  // its later member). Word w of every row j >= 32w is written, the words
  // the walk reads. Word by word, a lane holds its candidate of the word
  // and the block's warps take the rows in turn, four at a time, so the
  // warps' work is even and the rows' chains overlap; no lane branches.
  const Threshold t = make_threshold(thr);
  const int words = (K + 31) / 32;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if (w < words) {  // block-uniform
      const int i = min(w * 32 + lane, K - 1);
      const float4 a = box[i];
      const float area_a = area[i];
#pragma unroll 4
      for (int j = w * 32 + warp; j < K; j += kWarps) {
        const uint32_t bits = __ballot_sync(
            kFull, (w * 32 + lane < j) &
                       overlaps(a, area_a, box[j], area[j], t));
        if (lane == 0) earlier[j * kWords + w] = bits;
      }
    }
  }
  __syncthreads();
  PHASE(2);

  // The walk, one word of 32 candidates at a time, by warp 0 with the kept
  // mask in every lane's registers. Lane b holds candidate 32w + b: it is
  // gone if a kept candidate of an earlier word overlaps it (one AND a
  // word), else it is kept unless a kept candidate ahead of it in its word
  // overlaps it. Within the word this is solved as a fixed point: start
  // from every candidate that stands, and keep each that no candidate of
  // the estimate ahead of it overlaps, until the estimate repeats. After t
  // rounds the first t are final, so a word takes at most 32 rounds, and
  // as many as its longest chain of suppressions.
  if (warp == 0) {
    uint32_t kept[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      kept[w] = 0u;
      if (w < words) {  // warp-uniform
        const int j = min(w * 32 + lane, K - 1);
        const uint32_t* row = earlier + j * kWords;
        uint32_t ahead = 0u;
#pragma unroll
        for (int v = 0; v < w; ++v) ahead |= row[v] & kept[v];
        const uint32_t own = row[w];
        const bool stands = w * 32 + lane < K && ahead == 0u;
        uint32_t estimate = __ballot_sync(kFull, stands);
        for (;;) {
          const uint32_t next =
              __ballot_sync(kFull, stands && (own & estimate) == 0u);
          if (next == estimate) break;
          estimate = next;
        }
        kept[w] = estimate;
      }
    }
    if (lane < kWords) {
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        if (w == lane) kept_mask[w] = kept[w];
    }
  }
  __syncthreads();
  PHASE(3);

  for (int j = threadIdx.x; j < K; j += kThreads)
    out[set * K + j] = ((kept_mask[j >> 5] >> (j & 31)) & 1u)
                           ? scores[set * K + j]
                           : 0.f;
  PHASE(4);
}

// Makes `device` current for one launch and gives the caller back its own
// device afterwards (one cudaGetDevice when it is already current).
struct DeviceGuard {
  int restore = -1;
  cudaError_t error;
  explicit DeviceGuard(int device) {
    int current = -1;
    error = cudaGetDevice(&current);
    if (error == cudaSuccess && current != device) {
      error = cudaSetDevice(device);
      if (error == cudaSuccess) restore = current;
    }
  }
  ~DeviceGuard() {
    if (restore >= 0) cudaSetDevice(restore);
  }
};

// Opts an instance into the shared memory of its largest K (32 * kWords),
// once per device; the attribute is a cap, so every launch fits.
template <int kWords>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      suppress_kernel<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(32 * kWords, kWords));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int kWords>
cudaError_t launch(const float* boxes, const float* scores, float* out,
                   int sets, int K, float thr, int device,
                   cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<kWords>(device);
  if (err != cudaSuccess) return err;
  suppress_kernel<kWords><<<sets, kThreads, smem_bytes(K, kWords), stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, out, K, thr);
  return cudaGetLastError();
}

}  // namespace

// boxes [sets, K, 4] f32 (16-byte aligned), scores [sets, K] f32, out
// [sets, K] f32, all contiguous on `device`, the stream's device;
// 0 < K <= 1024, sets = B * C. Returns a cudaError_t (0 = launched).
extern "C" int wt_nms_suppress(const float* boxes, const float* scores,
                               float* out, int sets, int K, float thr,
                               int device, cudaStream_t stream) {
  if (sets <= 0 || K <= 0 || K > kMaxK) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return guard.error;
  if (K <= 128)
    return launch<4>(boxes, scores, out, sets, K, thr, device, stream);
  if (K <= 256)
    return launch<8>(boxes, scores, out, sets, K, thr, device, stream);
  if (K <= 512)
    return launch<16>(boxes, scores, out, sets, K, thr, device, stream);
  return launch<32>(boxes, scores, out, sets, K, thr, device, stream);
}

#ifdef WT_PHASE_CLOCK
// the stamps of the first `blocks` blocks, [blocks][2 * kStamps]
// (globaltimer ns, then clock64 cycles), into host memory; then clears them
extern "C" int wt_phase_stamps(void* host, int blocks) {
  if (blocks <= 0 || blocks > kStampBlocks) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(g_stamps[0]) * blocks;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps, bytes);
  void* dev = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, g_stamps);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(g_stamps));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return err;
}

extern "C" int wt_empty_kernel(int grid_x, int grid_y, int threads,
                               cudaStream_t stream) {
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0, stream>>>();
  return cudaGetLastError();
}
#endif
