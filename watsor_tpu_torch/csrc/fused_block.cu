// Fused stride-1 MobileNetV2 inverted-residual block, BatchNorm folded:
// 1x1 expand + relu6 -> 3x3 SAME depthwise + relu6 -> linear 1x1 project
// (+ residual), NHWC.
//
// Replaces: watsor_tpu/ops/fused_block.py fused_inverted_residual, the
// Pallas TPU kernel that runs 12 of MobileNetV2's 17 blocks under
// WATSOR_FUSED_BLOCKS=1.
//
// What bounds it on the H100: run as three convolutions, the block writes
// the 6x-expanded activation to device memory and reads it back twice;
// that traffic, not the arithmetic, is what the TPU kernel removed.
//
// What the design does about it: the expanded tensor never leaves the SM.
// One block owns a tile of output rows of one image. It stages the tile's
// input rows plus a one-row halo in shared memory once, then walks the
// expanded channels in chunks of kChunk: expand the chunk over the halo
// rows on the tensor cores (bf16 operands, f32 sums, via WMMA), add the
// bias, relu6, round to bf16; run the chunk's depthwise on the CUDA cores
// (f32 sums, bias, relu6, round to bf16); and add the chunk's share of
// the projection, again on the tensor cores, into an f32 accumulator
// tile in shared memory. Device memory sees only the input tile, the
// weights and the output tile. The rounding points are those of the TPU
// kernel (ops/fused_block.py), so the two differ only in the order of f32
// sums. GEMM tiles are 16x16x16, so pixel and channel counts are padded
// to 16 with zeros in shared memory. Still to come: wgmma and TMA, and
// an expand that is not recomputed for the halo rows of each tile.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;                   // WMMA m = n = k
constexpr size_t kMaxSmem = 227 * 1024;     // per-block limit on sm_90
constexpr int kMaxDevices = 64;
// expanded channels per pass: 3 WMMA tiles; every E of MobileNetV2 (144,
// 192, 384, 576, 960) is a multiple. Measured against 32 and 64 on the
// 12 main-path shapes at batch 8 (python -m watsor_tpu_torch.profile_step
// --chunks 32,48,64 builds those with -DWT_FUSED_CHUNK), 48 was fastest.
#ifndef WT_FUSED_CHUNK
#define WT_FUSED_CHUNK 48
#endif
constexpr int kChunk = WT_FUSED_CHUNK;
static_assert(kChunk > 0 && kChunk % kTile == 0, "chunk of 16s");

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline size_t take(size_t* offset, size_t bytes) {
  const size_t at = *offset;
  *offset = (at + bytes + 127) / 128 * 128;  // WMMA wants 32-byte alignment
  return at;
}

// Byte offsets of the shared-memory buffers of one block.
struct Layout {
  int cin_p, cout_p, p_in, p_in_p, p_out, p_out_p;
  size_t acc, e_sum, xs, we, e, wp, wdw, be, bdw, total;
};

__host__ __device__ inline Layout make_layout(int R, int W, int Cin,
                                              int Cout) {
  Layout l;
  l.cin_p = round_up(Cin, kTile);
  l.cout_p = round_up(Cout, kTile);
  l.p_in = (R + 2) * W;                     // staged pixels, with halo
  l.p_in_p = round_up(l.p_in, kTile);
  l.p_out = R * W;
  l.p_out_p = round_up(l.p_out, kTile);
  size_t off = 0;
  l.acc = take(&off, (size_t)l.p_out_p * l.cout_p * sizeof(float));
  // expand sums; the depthwise output reuses the space once they are read
  l.e_sum = take(&off, (size_t)l.p_in_p * kChunk * sizeof(float));
  l.xs = take(&off, (size_t)l.p_in_p * l.cin_p * sizeof(bf16));
  l.we = take(&off, (size_t)l.cin_p * kChunk * sizeof(bf16));
  l.e = take(&off, (size_t)l.p_in_p * kChunk * sizeof(bf16));
  l.wp = take(&off, (size_t)kChunk * l.cout_p * sizeof(bf16));
  l.wdw = take(&off, 9 * kChunk * sizeof(bf16));
  l.be = take(&off, kChunk * sizeof(float));
  l.bdw = take(&off, kChunk * sizeof(float));
  l.total = off;
  return l;
}

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 load_bf16(const float* p) { return to_bf16(*p); }
__device__ __forceinline__ bf16 load_bf16(const bf16* p) { return *p; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = to_bf16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const T* __restrict__ x, const bf16* __restrict__ we,
                   const float* __restrict__ be, const bf16* __restrict__ wdw,
                   const float* __restrict__ bdw, const bf16* __restrict__ wp,
                   const float* __restrict__ bp, T* __restrict__ out, int H,
                   int W, int Cin, int E, int Cout, int R, int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(R, W, Cin, Cout);
  float* acc = reinterpret_cast<float*>(smem + L.acc);     // [p_out_p][cout_p]
  float* e_sum = reinterpret_cast<float*>(smem + L.e_sum); // [p_in_p][kChunk]
  bf16* d_s = reinterpret_cast<bf16*>(smem + L.e_sum);     // [p_out_p][kChunk]
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);         // [p_in_p][cin_p]
  bf16* we_s = reinterpret_cast<bf16*>(smem + L.we);       // [cin_p][kChunk]
  bf16* e_s = reinterpret_cast<bf16*>(smem + L.e);         // [p_in_p][kChunk]
  bf16* wp_s = reinterpret_cast<bf16*>(smem + L.wp);       // [kChunk][cout_p]
  bf16* wdw_s = reinterpret_cast<bf16*>(smem + L.wdw);     // [9][kChunk]
  float* be_s = reinterpret_cast<float*>(smem + L.be);     // [kChunk]
  float* bdw_s = reinterpret_cast<float*>(smem + L.bdw);   // [kChunk]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * R;                 // first output row
  const int rows = min(R, H - r0);               // output rows of this tile
  const size_t image = (size_t)blockIdx.y * H * W;
  const bf16 zero = to_bf16(0.f);

  // a staged pixel p (row rr of the halo tile) is inside the image
  auto staged_in_image = [&](int p) {
    const int rr = p / W;
    const int h = r0 - 1 + rr;
    return p < L.p_in && h >= 0 && h < H && rr < rows + 2;
  };

  // input rows r0-1 .. r0+rows, zero outside the image (SAME padding) and
  // in the padding to 16 pixels and 16 channels; `first` is the image
  // pixel of staged pixel 0, one row above the tile
  const long long first = (long long)image + (long long)(r0 - 1) * W;
  for (int i = tid; i < L.p_in_p * L.cin_p; i += kThreads) {
    const int p = i / L.cin_p;
    const int k = i - p * L.cin_p;
    xs[i] = (k < Cin && staged_in_image(p))
                ? load_bf16(x + (first + p) * Cin + k)
                : zero;
  }
  for (int i = tid; i < L.p_out_p * L.cout_p; i += kThreads) acc[i] = 0.f;

  for (int e0 = 0; e0 < E; e0 += kChunk) {
    const int ec = min(kChunk, E - e0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < L.cin_p * kChunk; i += kThreads) {
      const int k = i / kChunk, c = i - k * kChunk;
      we_s[i] = (k < Cin && c < ec) ? we[(size_t)k * E + e0 + c] : zero;
    }
    for (int i = tid; i < kChunk * L.cout_p; i += kThreads) {
      const int c = i / L.cout_p, co = i - c * L.cout_p;
      wp_s[i] = (c < ec && co < Cout) ? wp[(size_t)(e0 + c) * Cout + co]
                                      : zero;
    }
    for (int i = tid; i < 9 * kChunk; i += kThreads) {
      const int t = i / kChunk, c = i - t * kChunk;
      wdw_s[i] = c < ec ? wdw[(size_t)t * E + e0 + c] : zero;
    }
    for (int i = tid; i < kChunk; i += kThreads) {
      be_s[i] = i < ec ? be[e0 + i] : 0.f;
      bdw_s[i] = i < ec ? bdw[e0 + i] : 0.f;
    }
    __syncthreads();

    // expand on the tensor cores: [p_in_p, cin_p] x [cin_p, kChunk]
    for (int t = warp; t < (L.p_in_p / kTile) * (kChunk / kTile);
         t += kWarps) {
      const int mt = t / (kChunk / kTile), nt = t % (kChunk / kTile);
      wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> sum;
      wmma::fill_fragment(sum, 0.f);
      for (int k = 0; k < L.cin_p; k += kTile) {
        wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, bf16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, bf16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, xs + mt * kTile * L.cin_p + k, L.cin_p);
        wmma::load_matrix_sync(b, we_s + k * kChunk + nt * kTile, kChunk);
        wmma::mma_sync(sum, a, b, sum);
      }
      wmma::store_matrix_sync(e_sum + mt * kTile * kChunk + nt * kTile, sum,
                              kChunk, wmma::mem_row_major);
    }
    __syncthreads();

    // bias, relu6, bf16; pixels outside the image stay zero
    for (int i = tid; i < L.p_in_p * kChunk; i += kThreads) {
      const int c = i % kChunk;
      const int p = i / kChunk;
      e_s[i] = to_bf16((c < ec && staged_in_image(p))
                           ? relu6(e_sum[i] + be_s[c]) : 0.f);
    }
    __syncthreads();

    // 3x3 depthwise, taps in the TPU kernel's (row, column) order
    for (int i = tid; i < L.p_out_p * kChunk; i += kThreads) {
      const int c = i % kChunk;
      const int pix = i / kChunk;
      float v = 0.f;
      if (pix < L.p_out) {
        const int r = pix / W, w = pix - r * W;
        float sum = 0.f;
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const int ww = w + dc - 1;
            const float tap =
                (ww >= 0 && ww < W)
                    ? to_f32(e_s[((size_t)(r + dr) * W + ww) * kChunk + c])
                    : 0.f;
            sum = fmaf(tap, to_f32(wdw_s[(dr * 3 + dc) * kChunk + c]), sum);
          }
        }
        v = relu6(sum + bdw_s[c]);
      }
      d_s[i] = to_bf16(v);
    }
    __syncthreads();

    // this chunk's share of the projection on the tensor cores:
    // acc[p_out_p, cout_p] += d[p_out_p, kChunk] x wp[kChunk, cout_p]
    const int n_tiles = L.cout_p / kTile;
    for (int t = warp; t < (L.p_out_p / kTile) * n_tiles; t += kWarps) {
      const int mt = t / n_tiles, nt = t % n_tiles;
      float* tile = acc + mt * kTile * L.cout_p + nt * kTile;
      wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> sum;
      wmma::load_matrix_sync(sum, tile, L.cout_p, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < kChunk; k += kTile) {
        wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, bf16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, bf16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(a, d_s + mt * kTile * kChunk + k, kChunk);
        wmma::load_matrix_sync(b, wp_s + k * L.cout_p + nt * kTile, L.cout_p);
        wmma::mma_sync(sum, a, b, sum);
      }
      wmma::store_matrix_sync(tile, sum, L.cout_p, wmma::mem_row_major);
    }
  }
  __syncthreads();

  T* out_tile = out + (image + (size_t)r0 * W) * Cout;
  for (int i = tid; i < rows * W * Cout; i += kThreads) {
    const int pix = i / Cout;
    const int co = i - pix * Cout;
    float v = acc[pix * L.cout_p + co] + bp[co];
    // residual from the bf16-rounded input (row r + 1 of the staged tile)
    if (residual) v += to_f32(xs[(size_t)(pix + W) * L.cin_p + co]);
    store(out_tile + i, v);
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

// Opts the kernel into the largest dynamic shared memory a block may
// take, once per device; the attribute is a cap, so every launch fits.
template <typename T>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t launch(const T* x, const bf16* we, const float* be,
                   const bf16* wdw, const float* bdw, const bf16* wp,
                   const float* bp, T* out, int B, int H, int W, int Cin,
                   int E, int Cout, int residual, int device,
                   cudaStream_t stream) {
  // rows per block: enough blocks for 132 SMs at the main path's batch,
  // few enough that the halo's recomputed expand rows stay a small share
  int R = H >= 64 ? 4 : (H >= 32 ? 2 : 1);
  while (R > 1 && make_layout(R, W, Cin, Cout).total > kMaxSmem) --R;
  const size_t smem = make_layout(R, W, Cin, Cout).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem<T>(device);
  if (err != cudaSuccess) return err;
  dim3 grid((H + R - 1) / R, B);
  fused_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, we, be, wdw, bdw, wp, bp, out, H, W, Cin, E, Cout, R, residual);
  return cudaGetLastError();
}

}  // namespace

// x, out [B, H, W, C] NHWC contiguous, bf16 (x_is_bf16 = 1) or f32;
// we [Cin, E], wdw [3, 3, E], wp [E, Cout] bf16; be [E], bdw [E], bp [Cout]
// f32. residual requires Cin == Cout. `device` is the stream's device.
// Returns a cudaError_t (0 = launched).
extern "C" int wt_fused_inverted_residual(
    const void* x, int x_is_bf16, const void* we, const float* be,
    const void* wdw, const float* bdw, const void* wp, const float* bp,
    void* out, int B, int H, int W, int Cin, int E, int Cout, int residual,
    int device, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || E <= 0 || Cout <= 0 ||
      B > 65535 || (residual && Cin != Cout))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return guard.error;
  const bf16* we_ = static_cast<const bf16*>(we);
  const bf16* wdw_ = static_cast<const bf16*>(wdw);
  const bf16* wp_ = static_cast<const bf16*>(wp);
  if (x_is_bf16)
    return launch(static_cast<const bf16*>(x), we_, be, wdw_, bdw, wp_, bp,
                  static_cast<bf16*>(out), B, H, W, Cin, E, Cout, residual,
                  device, stream);
  return launch(static_cast<const float*>(x), we_, be, wdw_, bdw, wp_, bp,
                static_cast<float*>(out), B, H, W, Cin, E, Cout, residual,
                device, stream);
}
