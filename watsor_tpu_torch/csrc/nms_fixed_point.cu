// Exact greedy keep-mask over the fused NMS candidate union.
//
// Replaces: watsor_tpu/ops/nms_pallas.py fixed_point_suppress
// (_fixed_point_kernel), the Pallas TPU kernel behind the fused_exact
// suppression. Same result bit for bit: per class, repeatedly pick the best
// live candidate (score descending, lower index on ties), keep it, and
// retire it and every candidate whose IoU with it exceeds the threshold.
//
// What bounds it on the H100: neither bytes (B*M*M*4 bytes of IoU, 64 KB an
// image at M = 128) nor operations, but the serial dependence of the greedy
// loop: up to M dependent pick-and-retire steps per class.
//
// What the design does about it: the loop never leaves the SM and never
// touches device memory. The image's overlap relation iou > thr is built
// once per block as an M x M bitmask in shared memory (2 KB at M = 128),
// one warp ballot per 32 columns; all eight warps of the block build rows,
// each with all of a row's loads in flight (built by one warp per class
// instead, the build took most of the kernel's 0.1 ms at C = 2). Each
// class is one warp holding its M candidates in registers (M/32 a lane,
// strided so that the loads coalesce); a step is a lane-local argmax, a
// five-round shuffle argmax, and one broadcast read of the picked row of
// the bitmask. A class stops as soon as it has no live candidate, which
// does not change the result.

#include <atomic>

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // one class per warp; all build the bitmask
// a candidate is live while its score is above the TPU kernel's retired
// sentinel threshold (_NEG * 0.5 in nms_pallas.py)
constexpr float kLiveAbove = -1.5e38f;
constexpr int kMaxDevices = 64;

template <int kPerLane>
__global__ void fixed_point_kernel(const float* __restrict__ scores,
                                   const float* __restrict__ iou,
                                   uint8_t* __restrict__ keep, int C, int M,
                                   float thr) {
  extern __shared__ uint32_t overlap[];  // [M][words], bit = column
  const int words = (M + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y;

  // one warp per row; each lane keeps its kPerLane loads in flight at once
  const float* iou_b = iou + (size_t)b * M * M;
  for (int row = warp; row < M; row += warps) {
    const float* iou_row = iou_b + (size_t)row * M;
    float v[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int col = k * 32 + lane;
      v[k] = col < M ? iou_row[col] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (k < words) {  // warp-uniform
        const unsigned bits = __ballot_sync(kFull, k * 32 + lane < M &&
                                                       v[k] > thr);
        if (lane == 0) overlap[row * words + k] = bits;
      }
    }
  }
  __syncthreads();

  const int c = blockIdx.x * warps + warp;
  if (c >= C) return;  // warp-uniform
  const float* s = scores + ((size_t)b * C + c) * M;
  float val[kPerLane];
  unsigned alive = 0;  // bit k: candidate k * 32 + lane
  unsigned kept = 0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = k * 32 + lane;
    val[k] = j < M ? s[j] : 0.f;
    if (j < M && val[k] > kLiveAbove) alive |= 1u << k;
  }

  while (__any_sync(kFull, alive != 0)) {
    float best = -INFINITY;
    int best_j = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      // ascending k is ascending index: a strict compare keeps the lower
      // index among equal scores
      if (((alive >> k) & 1u) && val[k] > best) {
        best = val[k];
        best_j = k * 32 + lane;
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float other = __shfl_xor_sync(kFull, best, offset);
      const int other_j = __shfl_xor_sync(kFull, best_j, offset);
      if (other > best || (other == best && other_j < best_j)) {
        best = other;
        best_j = other_j;
      }
    }
    const int pick = best_j;  // the same in every lane
    const uint32_t* row = overlap + (size_t)pick * words;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (k < words && ((row[k] >> lane) & 1u)) alive &= ~(1u << k);
    }
    if ((pick & 31) == lane) {
      kept |= 1u << (pick >> 5);
      alive &= ~(1u << (pick >> 5));
    }
  }

  uint8_t* out = keep + ((size_t)b * C + c) * M;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = k * 32 + lane;
    if (j < M) out[j] = (kept >> k) & 1u;
  }
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

// Opts an instance into the bitmask of its largest M (kPerLane * 32 rows
// of kPerLane words), once per device; the attribute is a cap, so every
// launch fits.
template <int kPerLane>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fixed_point_kernel<kPerLane>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kPerLane * 32 * kPerLane * sizeof(uint32_t)));
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int kPerLane>
cudaError_t launch(const float* scores, const float* iou, uint8_t* keep,
                   int B, int C, int M, float thr, int device,
                   cudaStream_t stream) {
  const int words = (M + 31) / 32;
  const size_t smem = (size_t)M * words * sizeof(uint32_t);
  const cudaError_t err = allow_max_smem<kPerLane>(device);
  if (err != cudaSuccess) return err;
  dim3 grid((C + kWarps - 1) / kWarps, B);
  fixed_point_kernel<kPerLane><<<grid, kWarps * 32, smem, stream>>>(
      scores, iou, keep, C, M, thr);
  return cudaGetLastError();
}

}  // namespace

// scores [B, C, M] f32, iou [B, M, M] f32, keep [B, C, M] bytes (0/1), all
// contiguous on `device`, the stream's device; M <= 1024. Returns a
// cudaError_t (0 = launched).
extern "C" int wt_fixed_point_suppress(const float* scores, const float* iou,
                                       uint8_t* keep, int B, int C, int M,
                                       float thr, int device,
                                       cudaStream_t stream) {
  if (B <= 0 || C <= 0 || M <= 0 || M > 1024) return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return guard.error;
  const int words = (M + 31) / 32;
  if (words <= 4)
    return launch<4>(scores, iou, keep, B, C, M, thr, device, stream);
  if (words <= 8)
    return launch<8>(scores, iou, keep, B, C, M, thr, device, stream);
  if (words <= 16)
    return launch<16>(scores, iou, keep, B, C, M, thr, device, stream);
  return launch<32>(scores, iou, keep, B, C, M, thr, device, stream);
}
