// int8 x int8 matrix product with int32 sums and a fused requantizing
// epilogue: the pointwise (1x1) units of the int8 SSD-MobileNetV2 walk.
//
// Replaces: watsor_tpu/ops/int8_matmul.py int8_matmul_requant (_call,
// _requant_kernel, _float_kernel), the Pallas TPU kernel behind
// WATSOR_INT8_POINTWISE=pallas.
//
//   y = acc * (scale[n] * inv) + bias[n] * inv, acc = sum_k x[m, k] w[k, n]
//   relu6:       y = min(max(y, 0), hi)           (hi = 6 * inv)
//   int8 output: out = clip(rint(y), -127, 127)   (rint: half to even)
//   f32 output:  out = y                          (inv = 1, hi = 6)
//
// with inv = 1 / out_scale folded into the scale and bias as the TPU kernel
// folds it (int8_matmul.py:121-126). Every rounding is the plain version's
// (ops/int8_matmul.py int8_matmul_requant_plain): the product is exact in
// int32, its conversion to f32 rounds to nearest, and each multiply and add
// is an _rn intrinsic, so that nvcc contracts none into an FMA. Kernel and
// plain version agree bit for bit.
//
// What bounds it on the H100: bytes. The main path's products are thin
// (K and N from 16 to 1280, M up to 180,000 rows at batch 8); at K = 16,
// N = 96 a row reads 16 bytes and writes 96, against 3,072 int8 operations.
//
// What the design does about it: one pass over x and one over the output,
// with nothing in between in device memory. A block owns a 128 x 64 output
// tile; eight warps each take 32 x 32 of it as four 16x16x16 int8 WMMA
// tiles (int32 sums on the tensor cores). The K loop stages 32-deep slices
// of x and w in shared memory, zero-filled past M, K and N, with 16-, 4- or
// 1-byte loads as the row widths allow (K = 24 rows are not 16-byte
// aligned). The sums go through shared memory to the epilogue, which walks
// the tile's valid rows and columns so that consecutive threads store
// consecutive output bytes. No wgmma and no TMA yet.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;  // output rows a block
constexpr int BN = 64;   // output columns a block
constexpr int BK = 32;   // depth of a shared-memory slice
constexpr int kThreads = 256;
constexpr int LDC = BN + 4;  // int32 row stride of the staged sums

template <int V>
struct Vec;
template <>
struct Vec<16> {
  using T = int4;
};
template <>
struct Vec<4> {
  using T = int;
};
template <>
struct Vec<1> {
  using T = signed char;
};

struct Smem {
  // slices in 16-wide column blocks, so that every WMMA tile starts on a
  // 256-bit boundary: a[kb][row][k % 16], b[nb][k][n % 16]
  alignas(128) signed char a[BK / 16][BM][16];
  alignas(128) signed char b[BN / 16][BK][16];
  alignas(128) int c[BM][LDC];
};

// x[m0:m0+BM, k0:k0+BK] -> s.a; V divides K and x's alignment
template <int V>
__device__ __forceinline__ void load_x(Smem& s, const signed char* x, int M,
                                       int K, int m0, int k0) {
  using T = typename Vec<V>::T;
  constexpr int per_row = BK / V;
  for (int i = threadIdx.x; i < BM * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * V;
    T v{};
    if (m0 + r < M && k0 + c < K)
      v = *reinterpret_cast<const T*>(x + (size_t)(m0 + r) * K + k0 + c);
    *reinterpret_cast<T*>(&s.a[c >> 4][r][c & 15]) = v;
  }
}

// w[k0:k0+BK, n0:n0+BN] -> s.b; V divides N and w's alignment
template <int V>
__device__ __forceinline__ void load_w(Smem& s, const signed char* w, int K,
                                       int N, int k0, int n0) {
  using T = typename Vec<V>::T;
  constexpr int per_row = BN / V;
  for (int i = threadIdx.x; i < BK * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * V;
    T v{};
    if (k0 + r < K && n0 + c < N)
      v = *reinterpret_cast<const T*>(w + (size_t)(k0 + r) * N + n0 + c);
    *reinterpret_cast<T*>(&s.b[c >> 4][r][c & 15]) = v;
  }
}

template <int VX, int VW>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const signed char* __restrict__ x,
                       const signed char* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, float inv, float hi,
                       int relu6, signed char* __restrict__ out_i8,
                       float* __restrict__ out_f32, int M, int K, int N) {
  __shared__ Smem s;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32;  // the warp's 32 x 32 of the tile
  const int wn = (warp >> 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_x<VX>(s, x, M, K, m0, k0);
    load_w<VW>(s, w, K, N, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &s.a[kb][wm + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &s.b[(wn >> 4) + j][kb * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&s.c[wm + i * 16][wn + j * 16], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  const int rows = min(BM, M - m0);
  const int cols = min(BN, N - n0);
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    const int n = n0 + c;
    const float sn = __fmul_rn(scale[n], inv);
    const float bn = __fmul_rn(bias[n], inv);
    float y = __fadd_rn(__fmul_rn((float)s.c[r][c], sn), bn);
    if (relu6) y = fminf(fmaxf(y, 0.f), hi);
    const size_t o = (size_t)(m0 + r) * N + n;
    if (out_i8 != nullptr)
      out_i8[o] = (signed char)fminf(fmaxf(rintf(y), -127.f), 127.f);
    else
      out_f32[o] = y;
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

// the widest load (16, 4 or 1 bytes) that divides the row width and the
// pointer's alignment
int vec_width(const void* p, int row) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (row % 16 == 0 && a % 16 == 0) return 16;
  if (row % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

template <int VX, int VW>
cudaError_t launch(const signed char* x, const signed char* w,
                   const float* scale, const float* bias, float inv, float hi,
                   int relu6, signed char* out_i8, float* out_f32, int M,
                   int K, int N, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_matmul_kernel<VX, VW><<<grid, kThreads, 0, stream>>>(
      x, w, scale, bias, inv, hi, relu6, out_i8, out_f32, M, K, N);
  return cudaGetLastError();
}

template <int VX>
cudaError_t launch_w(int vw, const signed char* x, const signed char* w,
                     const float* scale, const float* bias, float inv,
                     float hi, int relu6, signed char* out_i8, float* out_f32,
                     int M, int K, int N, cudaStream_t stream) {
  if (vw == 16)
    return launch<VX, 16>(x, w, scale, bias, inv, hi, relu6, out_i8, out_f32,
                          M, K, N, stream);
  if (vw == 4)
    return launch<VX, 4>(x, w, scale, bias, inv, hi, relu6, out_i8, out_f32,
                         M, K, N, stream);
  return launch<VX, 1>(x, w, scale, bias, inv, hi, relu6, out_i8, out_f32, M,
                       K, N, stream);
}

}  // namespace

// x [M, K] int8, w [K, N] int8, scale [N] f32, bias [N] f32, out [M, N]
// (int8 when out_is_i8, else f32), all contiguous on `device`, the stream's
// device; M, K, N > 0 and M / 128 < 2^31. Returns a cudaError_t
// (0 = launched).
extern "C" int wt_int8_matmul_requant(const signed char* x,
                                      const signed char* w,
                                      const float* scale, const float* bias,
                                      float inv, float hi, int relu6,
                                      void* out, int out_is_i8, int M, int K,
                                      int N, int device,
                                      cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (N + BN - 1) / BN > 65535)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return guard.error;
  signed char* out_i8 = out_is_i8 ? static_cast<signed char*>(out) : nullptr;
  float* out_f32 = out_is_i8 ? nullptr : static_cast<float*>(out);
  const int vx = vec_width(x, K);
  const int vw = vec_width(w, N);
  if (vx == 16)
    return launch_w<16>(vw, x, w, scale, bias, inv, hi, relu6, out_i8,
                        out_f32, M, K, N, stream);
  if (vx == 4)
    return launch_w<4>(vw, x, w, scale, bias, inv, hi, relu6, out_i8,
                       out_f32, M, K, N, stream);
  return launch_w<1>(vw, x, w, scale, bias, inv, hi, relu6, out_i8, out_f32,
                     M, K, N, stream);
}
