// Exact greedy keep-mask over the fused NMS candidate union, from the
// union's boxes.
//
// Replaces: watsor_tpu/ops/nms_pallas.py fixed_point_suppress
// (_fixed_point_kernel), the Pallas TPU kernel behind the fused_exact
// suppression, together with the IoU matrix that watsor_tpu/ops/nms.py
// builds for it (ops/boxes.py iou_matrix). Same result bit for bit: per
// class, repeatedly pick the best live candidate (score descending, lower
// index on ties), keep it, and retire it and every candidate whose IoU with
// it exceeds the threshold.
//
// What bounds it on the H100: neither bytes (scores, boxes and keep bytes,
// 2.6 KB a class at M = 128) nor operations (M(M-1)/2 IoUs a class), but
// the serial dependence of the greedy walk. The first version read an
// M x M IoU matrix that 23 elementwise launches had built, and took a
// shuffle argmax for each of up to M steps a class: 490 cycles a step, 82%
// of its time (PERF.md, the first version's phase split).
//
// What the design does about it: one block per (image, class), nothing of
// size M x M in device memory, and no argmax.
//  1. The class's scores and the image's boxes are staged in shared memory.
//  2. Each live candidate gets its rank in the class's order (score
//     descending, lower index on ties) by counting, four threads a
//     candidate; its box moves to that rank. This is the sort, done once.
//  3. The overlap relation iou > thr is built for the triangle in rank
//     order (bit r' of row r: r' < r and the two overlap), one warp
//     ballot per 32 candidates, every warp taking every 16th row, so the
//     warps' work is even. The IoU is rounded as iou_matrix rounds it, op
//     by op, with the _rn intrinsics, so that nvcc contracts no multiply
//     and add into an FMA, and its division is replaced by an exact test
//     (overlaps below): the bitmask is the plain version's, bit for bit.
//  4. One thread walks the ranks in order with the kept mask in
//     registers: a step is a bit test of the rank's row against it and,
//     for a kept candidate, one OR. No step waits on a load.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 4;  // threads that count one candidate's rank
constexpr int kMaxM = 1024;
// a candidate is live while its score is above the TPU kernel's retired
// sentinel threshold (_NEG * 0.5 in nms_pallas.py)
constexpr float kLiveAbove = -1.5e38f;
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

// shared memory of one block: the triangle, `words` words a row, then
// boxes by index and by rank, areas by rank, scores and ranks by index
size_t smem_bytes(int M, int words) {
  return (size_t)M * words * sizeof(uint32_t) +
         (size_t)M * (2 * sizeof(float4) + 3 * sizeof(float));
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
// 32 * kWords >= M
template <int kWords>
__global__ void __launch_bounds__(kThreads)
    fixed_point_kernel(const float* __restrict__ scores,
                       const float4* __restrict__ boxes,
                       uint8_t* __restrict__ keep, int C, int M, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* earlier = reinterpret_cast<uint32_t*>(smem);    // [M][kWords]
  float4* box = reinterpret_cast<float4*>(earlier + M * kWords);  // [M]
  float4* sbox = box + M;                                   // [M] by rank
  float* sarea = reinterpret_cast<float*>(sbox + M);        // [M] by rank
  float* score = sarea + M;                                 // [M] by index
  int* rank = reinterpret_cast<int*>(score + M);            // [M], -1: dead
  __shared__ uint32_t kept_by_rank[kWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t set = blockIdx.x;  // one (image, class)
  PHASE(0);

  const float* s = scores + set * M;
  const float4* bx = boxes + (set / C) * M;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    score[i] = s[i];
    box[i] = bx[i];
  }
  __syncthreads();
  PHASE(1);

  // rank of a live i: the candidates ahead of it, #{j: s_j > s_i, or
  // s_j == s_i and j < i}; such a j is live when i is, and a NaN is never
  // ahead. Thread `part` of a candidate's four counts j = part mod 4.
  const int part = threadIdx.x % kSplit;
  int live = 0;  // the live candidates, ranks 0 .. live - 1
  for (int base = 0; base < M; base += kThreads / kSplit) {
    const int i = base + threadIdx.x / kSplit;
    int ahead = 0;
    float si = 0.f;
    if (i < M) {
      si = score[i];
#pragma unroll 8
      for (int j = part; j < M; j += kSplit) {
        const float sj = score[j];
        ahead += (sj > si) | ((sj == si) & (j < i));
      }
    }
    ahead += __shfl_xor_sync(kFull, ahead, 1);
    ahead += __shfl_xor_sync(kFull, ahead, 2);
    const bool is_live = i < M && part == 0 && si > kLiveAbove;
    if (i < M && part == 0) {
      rank[i] = is_live ? ahead : -1;
      if (is_live) {
        const float4 b = box[i];
        sbox[ahead] = b;
        sarea[ahead] = box_area(b);
      }
    }
    live += __syncthreads_count(is_live);
  }
  PHASE(2);

  // earlier[r] bit r': r' < r and the two overlap, in rank order (the
  // triangle, stored by its later member). Word w of every row r >= 32w
  // is written, the words the walk reads. Word by word, a lane holds its
  // candidate of the word and the block's warps take the rows in turn,
  // four at a time, so the warps' work is even and the rows' chains
  // overlap; no lane branches.
  const Threshold t = make_threshold(thr);
  const int words = (live + 31) / 32;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if (w < words) {  // block-uniform
      const int i = min(w * 32 + lane, live - 1);
      const float4 a = sbox[i];
      const float area_a = sarea[i];
#pragma unroll 4
      for (int r = w * 32 + warp; r < live; r += kWarps) {
        const uint32_t bits = __ballot_sync(
            kFull, (w * 32 + lane < r) &
                       overlaps(a, area_a, sbox[r], sarea[r], t));
        if (lane == 0) earlier[r * kWords + w] = bits;
      }
    }
  }
  __syncthreads();
  PHASE(3);

  // The walk, one word of 32 ranks at a time, by warp 0 with the kept mask
  // in every lane's registers. Lane b holds rank 32w + b: it is gone if a
  // kept rank of an earlier word overlaps it (one AND a word), else it is
  // kept unless a kept rank ahead of it in its word overlaps it. Within
  // the word this is solved as the fixed point ops/nms.py iterates: start
  // from every rank that stands, and keep each that no rank of the
  // estimate ahead of it overlaps, until the estimate repeats. After t
  // rounds the first t ranks are final, so a word takes at most 32 rounds,
  // and as many as its longest chain of suppressions.
  if (warp == 0) {
    uint32_t kept[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      kept[w] = 0u;
      if (w < words) {  // warp-uniform
        const int r = min(w * 32 + lane, live - 1);
        const uint32_t* row = earlier + r * kWords;
        uint32_t ahead = 0u;
#pragma unroll
        for (int v = 0; v < w; ++v) ahead |= row[v] & kept[v];
        const uint32_t own = row[w];
        const bool stands = w * 32 + lane < live && ahead == 0u;
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
        if (w == lane) kept_by_rank[w] = kept[w];
    }
  }
  __syncthreads();
  PHASE(4);

  uint8_t* out = keep + set * M;
  for (int i = threadIdx.x; i < M; i += kThreads) {
    const int r = rank[i];
    out[i] = r >= 0 && ((kept_by_rank[r >> 5] >> (r & 31)) & 1u);
  }
  PHASE(5);
}

// Makes `device` current for one launch and gives the caller back its own
// device afterwards. When `device` is already current, as on the main
// path, this costs one cudaGetDevice, which reads a thread-local value.
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

// Opts an instance into the shared memory of its largest M (32 * kWords),
// once per device; the attribute is a cap, so every launch fits.
template <int kWords>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fixed_point_kernel<kWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(32 * kWords, kWords));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int kWords>
cudaError_t launch(const float* scores, const float* boxes, uint8_t* keep,
                   int B, int C, int M, float thr, int device,
                   cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<kWords>(device);
  if (err != cudaSuccess) return err;
  fixed_point_kernel<kWords>
      <<<B * C, kThreads, smem_bytes(M, kWords), stream>>>(
          scores, reinterpret_cast<const float4*>(boxes), keep, C, M, thr);
  return cudaGetLastError();
}

}  // namespace

// scores [B, C, M] f32, boxes [B, M, 4] f32 (16-byte aligned), keep
// [B, C, M] bytes (0/1), all contiguous on `device`, the stream's device;
// M <= 1024, B * C < 2^31. Returns a cudaError_t (0 = launched).
extern "C" int wt_fixed_point_suppress(const float* scores, const float* boxes,
                                       uint8_t* keep, int B, int C, int M,
                                       float thr, int device,
                                       cudaStream_t stream) {
  if (B <= 0 || C <= 0 || M <= 0 || M > kMaxM ||
      (long long)B * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return guard.error;
  if (M <= 128)
    return launch<4>(scores, boxes, keep, B, C, M, thr, device, stream);
  if (M <= 256)
    return launch<8>(scores, boxes, keep, B, C, M, thr, device, stream);
  if (M <= 512)
    return launch<16>(scores, boxes, keep, B, C, M, thr, device, stream);
  return launch<32>(scores, boxes, keep, B, C, M, thr, device, stream);
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
