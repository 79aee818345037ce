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
// int32 (|acc| <= 1280 * 127 * 127 < 2^31 on the int8 walk), its conversion
// to f32 rounds to nearest, and each multiply and add is an _rn intrinsic,
// so that nvcc contracts none into an FMA. Kernel and plain version agree
// bit for bit.
//
// What bounds it on the H100: bytes. The walk's products are thin (K and N
// from 16 to 1280, M up to 180,000 rows at batch 8): its 38 calls move
// 113.7 MB, 34 us at 3.35 TB/s, against 8.6 G int8 operations, 4.4 us of
// tensor cores. So no wgmma: mma.sync keeps pace with the bytes, and the
// 64-row warpgroup tiles of wgmma would buy nothing.
//
// The design (the second one). The first staged 32-deep slices of x and w
// with plain loads between two barriers, so nothing was in flight while
// the tensor cores ran; launched one 128 x 64 tile a block, which left most
// of the card idle where M is small and K deep and computed mostly zeros at
// N = 16 to 32; and sent every sum through shared memory to an epilogue that
// reread scale and bias from device memory for each element and stored
// single bytes. Now:
//
// - A launch plan per shape (ops/int8_matmul.py plan_launch, cached): tile
//   rows BM (64 or 128), tile columns BN (the narrowest of 16, 32, 64, 96
//   and 128 that covers N, else 128), a split of K over the S blocks of a
//   thread-block cluster (S <= 8, slices of at least 64) where the unsplit
//   launch leaves much of the card idle, and how many row tiles a block
//   walks. This file recomputes the shared-memory layout and refuses a plan
//   whose size disagrees.
// - Split K through distributed shared memory: each rank of a cluster sums
//   its K slice in int32 registers and stores them in fragment order in its
//   own shared memory; after a cluster barrier warp w of rank w % S adds the
//   other ranks' partials of its tile to its registers and runs the
//   epilogue. int32 addition is exact and associative, so any order gives
//   the same bits. No atomics, no second pass.
// - A pipelined K loop: a ring of 4 stages filled by cp.async (16-byte
//   cp.async.cg where the row width and the pointer allow, 8- or 4-byte
//   cp.async.ca otherwise, plain byte loads for odd widths), zero-filled
//   past M, N and the slice through the copy's source size; one wait and one
//   __syncthreads a stage. Where K is not split, a block walks several row
//   tiles through the same ring, so the next tile's x is in flight while a
//   tile ends; with one stage a slice, w is staged once.
// - Tensor-core products from registers: mma.sync m16n8k32 s8 with int32
//   sums, A from the x stage by ldmatrix (x is K-contiguous). B must be
//   K-major too and ldmatrix.trans moves only 16-bit elements, so each w
//   stage is transposed into a second buffer one stage ahead, through
//   registers, with 4 x 4 byte transposes by __byte_perm. w is at most
//   410 KB and read from L2; x and the output carry the bytes.
// - The epilogue from the accumulator registers: scale * inv and bias * inv
//   folded once per column per block into shared memory, then the fold,
//   relu6 and the rounding in registers, column groups wholly past N
//   skipped. An int8 output is staged per warp (its tile's bytes, not its
//   int32 sums) and written with the widest row stores N allows, 16 bytes
//   for N a multiple of 16; an f32 output is written as 8-byte column
//   pairs.
//
// Eight warps a block, four along M and two along N; a warp owns 16 * MT
// rows and 8 * NT columns (BM = 64 * MT with MT 1 or 2, BN = 16 * NT with
// NT 1, 2, 4, 6 or 8: ten instances).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarpsM = 4;                  // warps along M; 2 along N
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr size_t kMaxSmem = 227 * 1024;     // per-block limit on sm_90
constexpr int kMaxDevices = 64;
constexpr int kStages = 4;                  // ring slots of the K loop

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline size_t take(size_t* offset, size_t bytes) {
  const size_t at = *offset;
  *offset = (at + bytes + 127) / 128 * 128;
  return at;
}

// Shared-memory layout of one block; ops/int8_matmul.py _layout_bytes
// computes the same total. Row strides are in bytes.
struct Layout {
  int bk;                  // depth of a stage: 32 or 64
  int slots;               // ring slots that can hold a stage
  int sx, sk, sw, ss;      // x stage, transposed w, raw w, staged output
  size_t x_slot, w_slot;   // bytes of one slot's x and raw w
  size_t x, w, wt, partial, staged, fold, total;
};

__host__ __device__ inline Layout make_layout(int BM, int BN, int kslice,
                                              int S, int tiles) {
  Layout l;
  l.bk = kslice <= 32 ? 32 : 64;
  const int n_k = ceil_div(kslice, l.bk);
  l.slots = n_k * tiles < kStages ? n_k * tiles : kStages;
  // the rows ldmatrix reads are an odd number of 16-byte units long, so
  // the 8 rows of one read start in 8 different bank groups
  l.sx = l.bk + 16;
  l.sk = l.bk + 16;
  l.sw = BN + 16;
  l.ss = BN + 16;
  l.x_slot = (size_t)BM * l.sx;
  l.w_slot = (size_t)l.bk * l.sw;
  size_t off = 0;
  l.fold = take(&off, 2 * (size_t)BN * sizeof(float));
  const size_t ring = off;
  l.x = take(&off, l.slots * l.x_slot);
  // one K stage a slice: its w is staged once, outside the ring
  l.w = take(&off, (n_k == 1 ? 1 : l.slots) * l.w_slot);
  l.wt = take(&off, 2 * (size_t)BN * l.sk);
  if (S == 1) {
    // tiles end inside the K loop, while other warps still read the ring
    l.partial = 0;
    l.staged = take(&off, (size_t)BM * l.ss);
  } else {
    // one tile, ended after the K loop: the split-K partials reuse the
    // ring, and the staged output follows the partials, which other ranks
    // read until the last cluster barrier
    size_t after = ring;
    l.partial = take(&after, (size_t)BM * BN * sizeof(int));
    l.staged = take(&after, (size_t)BM * l.ss);
    if (after > off) off = after;
  }
  l.total = off;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int V>
struct Vec;
template <>
struct Vec<16> {
  using T = int4;
};
template <>
struct Vec<8> {
  using T = int2;
};
template <>
struct Vec<4> {
  using T = int;
};
template <>
struct Vec<2> {
  using T = short;
};
template <>
struct Vec<1> {
  using T = signed char;
};

// V bytes from src to dst, or V zeros when !valid (a source size of 0);
// plain loads for V = 1, which cp.async does not take
template <int V>
__device__ __forceinline__ void copy_async(signed char* dst,
                                           const signed char* src,
                                           bool valid) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else if constexpr (V == 8 || V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(V), "r"(valid ? V : 0));
  } else {
    *dst = valid ? *src : 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x[m0:m0+BM, k0:k0+bk] -> xs (row stride sx), zero past M and past k_end;
// V divides K and x's alignment
template <int V>
__device__ __forceinline__ void stage_x(signed char* xs,
                                        const signed char* x, int M, int K,
                                        int m0, int k0, int k_end, int BM,
                                        int bk, int sx) {
  const int per_row = bk / V;
  for (int i = threadIdx.x; i < BM * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    const bool valid = m0 + r < M && k0 + c < k_end;
    copy_async<V>(xs + r * sx + c,
                  valid ? x + (size_t)(m0 + r) * K + k0 + c : x, valid);
  }
}

// w[k0:k0+bk, n0:n0+BN] -> ws (row stride sw), zero past k_end and past N;
// V divides N and w's alignment
template <int V>
__device__ __forceinline__ void stage_w(signed char* ws,
                                        const signed char* w, int N, int n0,
                                        int k0, int k_end, int BN, int bk,
                                        int sw) {
  const int per_row = BN / V;
  for (int i = threadIdx.x; i < bk * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    const bool valid = k0 + r < k_end && n0 + c < N;
    copy_async<V>(ws + r * sw + c,
                  valid ? w + (size_t)(k0 + r) * N + n0 + c : w, valid);
  }
}

// raw w [bk][BN] (stride sw) -> wt [BN][bk] (stride sk): each thread moves
// 4 x 4 bytes, four rows of four columns in, four columns of four rows out
__device__ __forceinline__ void transpose_w(signed char* wt,
                                            const signed char* ws, int BN,
                                            int bk, int sw, int sk) {
  const int kq = bk / 4;
  for (int i = threadIdx.x; i < (BN / 4) * kq; i += kThreads) {
    const int kb = (i % kq) * 4, nb = (i / kq) * 4;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = *reinterpret_cast<const uint32_t*>(ws + (kb + j) * sw + nb);
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);  // r2b0 r3b0 r2b1 r3b1
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // r2b2 r3b2 r2b3 r3b3
    *reinterpret_cast<uint32_t*>(wt + (nb + 0) * sk + kb) =
        __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(wt + (nb + 1) * sk + kb) =
        __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(wt + (nb + 2) * sk + kb) =
        __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(wt + (nb + 3) * sk + kb) =
        __byte_perm(t2, t3, 0x7632);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage of a warp's 16*MT x 8*NT tile: rows wm0.. of xs [BM][sx] times
// columns wn0.. of wt [BN][sk], bk deep.
template <int MT, int NT>
__device__ __forceinline__ void mma_stage(int acc[MT][NT][4],
                                          const signed char* xs, int sx,
                                          const signed char* wt, int sk,
                                          int bk, int wm0, int wn0,
                                          int lane) {
  for (int kk = 0; kk < bk; kk += 32) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], xs + (wm0 + mt * 16 + (lane & 15)) * sx + kk +
                         (lane >> 4) * 16);
    uint32_t b[NT][2];
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t r[4];
      ldsm_x4(r, wt + (wn0 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * sk +
                     kk + ((lane >> 3) & 1) * 16);
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
    if constexpr (NT % 2) {
      ldsm_x2(b[NT - 1], wt + (wn0 + (NT - 1) * 8 + (lane & 7)) * sk + kk +
                             ((lane >> 3) & 1) * 16);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a[mt], b[nt]);
  }
}

// acc * s + b in f32, each operation rounded to nearest
__device__ __forceinline__ float fold_acc(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// clip(rint(clip(y, 0, hi)), -127, 127) with relu6, else clip(rint(y),
// -127, 127), as rint(clip(y, lo, up)): rint is monotone and the bounds
// are integers or hi, so clipping first changes nothing; the conversion
// rounds half to even
__device__ __forceinline__ int to_int8(float y, float lo, float up) {
  return __float2int_rn(fminf(fmaxf(y, lo), up));
}

// rows x cols bytes from the staged tile (stride ss) to out (stride N), V
// bytes a store, by one warp
template <int V>
__device__ __forceinline__ void store_rows(signed char* out,
                                           const signed char* st, int ss,
                                           int N, int rows, int cols,
                                           int lane) {
  using T = typename Vec<V>::T;
  const int per_row = cols / V;
  for (int i = lane; i < rows * per_row; i += 32) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    *reinterpret_cast<T*>(out + (size_t)r * N + c) =
        *reinterpret_cast<const T*>(st + r * ss + c);
  }
}

struct Args {
  const signed char* x;
  const signed char* w;
  const float* scale;
  const float* bias;
  float inv, hi;
  int relu6;
  signed char* out_i8;
  float* out_f32;
  int M, K, N, kslice, S, tiles, vx, vw;
};

// grid (S * G, ceil(N / BN)), clusters of (S, 1, 1): cluster c of column
// tile blockIdx.y works on row tiles c, c + G, c + 2G, ... (G clusters, at
// most `tiles` row tiles each; S > 1 only with one); its rank r on K
// [r*kslice, (r+1)*kslice). A block walks its (row tile, K stage) steps
// through one ring, so the next tile's x loads while a tile ends.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, MT * NT <= 4 ? 4 : 2)
    int8_matmul_kernel(Args a) {
  constexpr int BM = 16 * MT * kWarpsM, BN = 16 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(BM, BN, a.kslice, a.S, a.tiles);
  signed char* xs = reinterpret_cast<signed char*>(smem + L.x);
  signed char* ws = reinterpret_cast<signed char*>(smem + L.w);
  signed char* wt = reinterpret_cast<signed char*>(smem + L.wt);
  float* fold = reinterpret_cast<float*>(smem + L.fold);  // [2][BN]
  signed char* st = reinterpret_cast<signed char*>(smem + L.staged);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % kWarpsM) * 16 * MT;
  const int wn0 = (warp / kWarpsM) * 8 * NT;
  const int S = a.S, bk = L.bk;
  const int rank = blockIdx.x % S;
  const int first = blockIdx.x / S, G = gridDim.x / S;
  const int row_tiles = ceil_div(a.M, BM);
  const int n_tiles = first < row_tiles ? ceil_div(row_tiles - first, G) : 0;
  const int n0 = blockIdx.y * BN;
  const int k_begin = rank * a.kslice;
  const int k_end = min(a.K, k_begin + a.kslice);
  const int n_k = k_end > k_begin ? ceil_div(k_end - k_begin, bk) : 0;
  const int steps = n_tiles * n_k;
  const bool w_fixed = n_k == 1;  // one K stage: w staged once

  auto stage_w_at = [&](signed char* wd, int k0) {
    switch (a.vw) {
      case 16:
        stage_w<16>(wd, a.w, a.N, n0, k0, k_end, BN, bk, L.sw);
        break;
      case 8:
        stage_w<8>(wd, a.w, a.N, n0, k0, k_end, BN, bk, L.sw);
        break;
      case 4:
        stage_w<4>(wd, a.w, a.N, n0, k0, k_end, BN, bk, L.sw);
        break;
      default:
        stage_w<1>(wd, a.w, a.N, n0, k0, k_end, BN, bk, L.sw);
    }
  };
  // step s (row tile s / n_k, K stage s % n_k) into ring slot s % kStages; a
  // group is committed for every s, empty past the last step, so the waits
  // count alike
  auto issue = [&](int s) {
    if (s < steps) {
      const int slot = s % kStages;
      const int m0 = (first + s / n_k * G) * BM;
      const int k0 = k_begin + s % n_k * bk;
      signed char* xd = xs + slot * L.x_slot;
      switch (a.vx) {
        case 16:
          stage_x<16>(xd, a.x, a.M, a.K, m0, k0, k_end, BM, bk, L.sx);
          break;
        case 8:
          stage_x<8>(xd, a.x, a.M, a.K, m0, k0, k_end, BM, bk, L.sx);
          break;
        case 4:
          stage_x<4>(xd, a.x, a.M, a.K, m0, k0, k_end, BM, bk, L.sx);
          break;
        default:
          stage_x<1>(xd, a.x, a.M, a.K, m0, k0, k_end, BM, bk, L.sx);
      }
      if (!w_fixed) stage_w_at(ws + slot * L.w_slot, k0);
    }
    cp_async_commit();
  };

  int acc[MT][NT][4];
  auto clear = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;
  };

  // the output tile's rows [m0, m0 + BM) from the registers, by this
  // rank's warps; column groups wholly past N are skipped
  auto finish = [&](int m0, bool mine) {
    if (!mine) return;
    const int g = lane >> 2, t2 = (lane & 3) * 2;
    if (a.out_i8 != nullptr) {
      const float lo = a.relu6 ? 0.f : -127.f;
      const float up = a.relu6 ? fminf(a.hi, 127.f) : 127.f;
      __syncwarp();                  // the warp's last tile has left `st`
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wn0 + nt * 8 + t2;
        if (n0 + wn0 + nt * 8 >= a.N) break;
        const float s0 = fold[c], s1 = fold[c + 1];
        const float b0 = fold[BN + c], b1 = fold[BN + c + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm0 + mt * 16 + g + 8 * h;
            const int q0 =
                to_int8(fold_acc(acc[mt][nt][2 * h], s0, b0), lo, up);
            const int q1 =
                to_int8(fold_acc(acc[mt][nt][2 * h + 1], s1, b1), lo, up);
            *reinterpret_cast<unsigned short*>(st + r * L.ss + c) =
                (unsigned short)__byte_perm(q0, q1, 0x0040);
          }
      }
      __syncwarp();
      const int rows = min(16 * MT, a.M - (m0 + wm0));
      const int cols = min(8 * NT, a.N - (n0 + wn0));
      if (rows > 0 && cols > 0) {
        signed char* out = a.out_i8 + (size_t)(m0 + wm0) * a.N + n0 + wn0;
        const signed char* src = st + wm0 * L.ss + wn0;
        // the widest store that divides the row's bytes, N, and the
        // offsets in device and shared memory
        const unsigned span = (unsigned)cols | (unsigned)a.N |
                              (unsigned)(reinterpret_cast<uintptr_t>(out)) |
                              (unsigned)wn0;
        if (span % 16 == 0)
          store_rows<16>(out, src, L.ss, a.N, rows, cols, lane);
        else if (span % 8 == 0)
          store_rows<8>(out, src, L.ss, a.N, rows, cols, lane);
        else if (span % 4 == 0)
          store_rows<4>(out, src, L.ss, a.N, rows, cols, lane);
        else if (span % 2 == 0)
          store_rows<2>(out, src, L.ss, a.N, rows, cols, lane);
        else
          store_rows<1>(out, src, L.ss, a.N, rows, cols, lane);
      }
    } else {
      const bool pairs = a.N % 2 == 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wn0 + nt * 8 + t2, n = n0 + c;
        if (n0 + wn0 + nt * 8 >= a.N) break;
        const float s0 = fold[c], s1 = fold[c + 1];
        const float b0 = fold[BN + c], b1 = fold[BN + c + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm0 + mt * 16 + g + 8 * h;
            if (m >= a.M || n >= a.N) continue;
            float y0 = fold_acc(acc[mt][nt][2 * h], s0, b0);
            float y1 = fold_acc(acc[mt][nt][2 * h + 1], s1, b1);
            if (a.relu6) {
              y0 = fminf(fmaxf(y0, 0.f), a.hi);
              y1 = fminf(fmaxf(y1, 0.f), a.hi);
            }
            float* o = a.out_f32 + (size_t)m * a.N + n;
            if (pairs) {
              *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
            } else {
              o[0] = y0;
              if (n + 1 < a.N) o[1] = y1;
            }
          }
      }
    }
  };

  clear();
  if (w_fixed) stage_w_at(ws, k_begin);            // joins step 0's group
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  // the fold's loads wait while the ring's first stages are in flight
  for (int c = tid; c < BN; c += kThreads) {
    const bool valid = n0 + c < a.N;
    fold[c] = valid ? __fmul_rn(a.scale[n0 + c], a.inv) : 0.f;
    fold[BN + c] = valid ? __fmul_rn(a.bias[n0 + c], a.inv) : 0.f;
  }
  cp_async_wait<kStages - 2>();                    // step 0 has landed
  __syncthreads();
  if (steps > 0) transpose_w(wt, ws, BN, bk, L.sw, L.sk);
  for (int s = 0; s < steps; ++s) {
    // step s + 1 has landed, for its w transposes in this step; with w
    // fixed step s is enough
    if (w_fixed)
      cp_async_wait<kStages - 2>();
    else
      cp_async_wait<kStages - 3>();
    // step s's transposed w and step s + 1 (or s) are visible, and every
    // warp is done with step s - 1, whose slots are free again
    __syncthreads();
    issue(s + kStages - 1);                        // into step s - 1's slot
    if (!w_fixed && s + 1 < steps)
      transpose_w(wt + ((s + 1) & 1) * BN * L.sk,
                  ws + ((s + 1) % kStages) * L.w_slot, BN, bk, L.sw, L.sk);
    mma_stage<MT, NT>(acc, xs + (s % kStages) * L.x_slot, L.sx,
                      wt + (w_fixed ? 0 : s & 1) * BN * L.sk, L.sk, bk, wm0,
                      wn0, lane);
    if (S == 1 && s % n_k == n_k - 1) {
      finish((first + s / n_k * G) * BM, true);
      clear();
    }
  }
  if (S == 1) return;

  // split K: one row tile, every rank's sums needed for it
  cp_async_wait<0>();
  __syncthreads();                 // the ring is dead from here on
  cg::cluster_group cluster = cg::this_cluster();
  int4* part = reinterpret_cast<int4*>(smem + L.partial);
  int4* own = part + warp * MT * NT * 32 + lane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      own[(mt * NT + nt) * 32] = make_int4(acc[mt][nt][0], acc[mt][nt][1],
                                           acc[mt][nt][2], acc[mt][nt][3]);
  cluster.sync();                                  // every partial is stored
  const bool mine = warp % S == rank;              // this warp finalizes
  if (mine) {
    // the other ranks' partials of this warp's tile, in any order: int32
    // addition is exact and associative
    for (int q = 1; q < S; ++q) {
      const int4* remote = cluster.map_shared_rank(part, (rank + q) % S) +
                           warp * MT * NT * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int4 v = remote[(mt * NT + nt) * 32];
          acc[mt][nt][0] += v.x;
          acc[mt][nt][1] += v.y;
          acc[mt][nt][2] += v.z;
          acc[mt][nt][3] += v.w;
        }
    }
  }
  finish(first * BM, mine);
  cluster.sync();           // no block leaves while another reads its partials
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

// the widest copy (16, 8, 4 or 1 bytes) that divides the row width and the
// pointer's alignment
int vec_width(const void* p, int row) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (row % 16 == 0 && a % 16 == 0) return 16;
  if (row % 8 == 0 && a % 8 == 0) return 8;
  if (row % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

// Opts one instance into the largest dynamic shared memory a block may
// take, once per device; the attribute is a cap, so every launch fits.
template <int MT, int NT>
cudaError_t allow_max_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int MT, int NT>
cudaError_t launch(const Args& a, int smem, int device, cudaStream_t stream) {
  constexpr int BM = 16 * MT * kWarpsM, BN = 16 * NT;
  const Layout L = make_layout(BM, BN, a.kslice, a.S, a.tiles);
  if (L.total != (size_t)smem || L.total > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem<MT, NT>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim =
      dim3((unsigned)ceil_div(ceil_div(a.M, BM), a.tiles) * a.S,
           (unsigned)ceil_div(a.N, BN), 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = L.total;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = a.S;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = a.S > 1 ? 1 : 0;
  const cudaError_t launched =
      cudaLaunchKernelEx(&config, int8_matmul_kernel<MT, NT>, a);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

using Launcher = cudaError_t (*)(const Args&, int, int, cudaStream_t);

// [BM / 64 - 1][BN = 16, 32, 64, 96, 128]: a ragged N takes the next
// width up and computes a few zero columns
constexpr Launcher kLaunchers[2][5] = {
    {launch<1, 1>, launch<1, 2>, launch<1, 4>, launch<1, 6>, launch<1, 8>},
    {launch<2, 1>, launch<2, 2>, launch<2, 4>, launch<2, 6>, launch<2, 8>}};

// the column of kLaunchers for a tile width, or -1
int width_index(int bn) {
  switch (bn) {
    case 16:
      return 0;
    case 32:
      return 1;
    case 64:
      return 2;
    case 96:
      return 3;
    case 128:
      return 4;
    default:
      return -1;
  }
}

}  // namespace

// x [M, K] int8, w [K, N] int8, scale [N] f32, bias [N] f32, out [M, N]
// (int8 when out_is_i8, else f32), all contiguous on `device`, the stream's
// device. (bm, bn, kslice, splits, tiles, smem) is the launch plan of
// ops/int8_matmul.py plan_launch: bm 64 or 128, bn 16, 32, 64, 96 or 128,
// 1 <= splits <= 8 slices of kslice (a multiple of 32) that cover K with
// none empty, at most `tiles` row tiles a block (1 when K is split), smem
// the layout's bytes. Returns a cudaError_t (0 = launched).
extern "C" int wt_int8_matmul_requant(
    const signed char* x, const signed char* w, const float* scale,
    const float* bias, float inv, float hi, int relu6, void* out,
    int out_is_i8, int M, int K, int N, int bm, int bn, int kslice,
    int splits, int tiles, int smem, int device, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (bm != 64 && bm != 128) ||
      width_index(bn) < 0 || splits < 1 || splits > kMaxCluster ||
      kslice < 32 || kslice % 32 || (long long)kslice * splits < K ||
      (long long)kslice * (splits - 1) >= K || tiles < 1 ||
      (splits > 1 && tiles > 1) ||
      (long long)ceil_div(ceil_div(M, bm), tiles) * splits >= (1LL << 31) ||
      ceil_div(N, bn) > 65535)
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return guard.error;
  Args a;
  a.x = x;
  a.w = w;
  a.scale = scale;
  a.bias = bias;
  a.inv = inv;
  a.hi = hi;
  a.relu6 = relu6;
  a.out_i8 = out_is_i8 ? static_cast<signed char*>(out) : nullptr;
  a.out_f32 = out_is_i8 ? nullptr : static_cast<float*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  a.kslice = kslice;
  a.S = splits;
  a.tiles = tiles;
  a.vx = vec_width(x, K);
  a.vw = vec_width(w, N);
  return kLaunchers[bm / 64 - 1][width_index(bn)](a, smem, device, stream);
}
