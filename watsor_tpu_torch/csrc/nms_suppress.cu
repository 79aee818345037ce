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
// operations (K*K/2 IoUs, 5,000 at K = 100), but the serial greedy walk:
// K dependent steps for each (image, class).
//
// What the design does about it: one block of four warps per (image,
// class). The block computes the IoUs of the upper triangle (j > i) inline,
// as the TPU kernel does, and keeps only `iou > thr` as a K x K bitmask in
// shared memory (one ballot per 32 columns). Warp 0 then walks the K steps
// with the keep mask in registers (word w of the mask in lane w) and never
// touches device memory inside the loop: a step is one shuffle to read
// keep[i] and, when i is kept, one shared-memory word per lane.
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
constexpr int kThreads = 128;
constexpr int kMaxK = 1024;
constexpr int kMaxDevices = 64;

size_t smem_bytes(int K) {
  return (size_t)K * (sizeof(float4) + sizeof(float)) +
         (size_t)K * ((K + 31) / 32) * sizeof(uint32_t);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// iou_matrix of ops/boxes.py for one pair: boxes are (ymin, xmin, ymax, xmax)
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float inter =
      __fmul_rn(fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f),
                fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-8f));
}

__global__ void __launch_bounds__(kThreads)
    suppress_kernel(const float4* __restrict__ boxes,
                    const float* __restrict__ scores,
                    float* __restrict__ out, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (K + 31) / 32;
  float4* box = reinterpret_cast<float4*>(smem);              // [K]
  float* area = reinterpret_cast<float*>(box + K);            // [K]
  uint32_t* later = reinterpret_cast<uint32_t*>(area + K);    // [K][words]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t set = blockIdx.x;  // one (image, class) candidate set

  for (int j = threadIdx.x; j < K; j += kThreads) {
    const float4 b = boxes[set * K + j];
    box[j] = b;
    area[j] = box_area(b);
  }
  __syncthreads();

  // later[i] bit j: j > i and iou(i, j) > thr
  for (int i = warp; i < K; i += kThreads / 32) {
    const float4 bi = box[i];
    const float ai = area[i];
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      const bool hit = j > i && j < K && iou(bi, ai, box[j], area[j]) > thr;
      const unsigned bits = __ballot_sync(kFull, hit);
      if (lane == 0) later[i * words + w] = bits;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // lane w holds bits 32w..32w+31 of the keep mask
  const int live = K - lane * 32;
  unsigned keep = live >= 32 ? kFull : (live > 0 ? (1u << live) - 1u : 0u);
  for (int i = 0; i < K; ++i) {
    const unsigned owner = __shfl_sync(kFull, keep, i >> 5);
    if ((owner >> (i & 31)) & 1u) {  // warp-uniform
      if (lane < words) keep &= ~later[i * words + lane];
    }
  }
  // round w writes candidates 32w..32w+31, one a lane, from lane w's word
  for (int w = 0; w < words; ++w) {
    const unsigned word = __shfl_sync(kFull, keep, w);
    const int j = w * 32 + lane;
    if (j < K) out[set * K + j] = ((word >> lane) & 1u) ? scores[set * K + j]
                                                        : 0.f;
  }
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

// Opts the kernel into the shared memory of K = 1024 (148 KB), once per
// device; the attribute is a cap, so every launch fits.
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxK));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
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
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_max_smem(device);
    if (err != cudaSuccess) return err;
  }
  suppress_kernel<<<sets, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, out, K, thr);
  return cudaGetLastError();
}
