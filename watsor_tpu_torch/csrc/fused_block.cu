// Fused stride-1 MobileNetV2 inverted-residual block, BatchNorm folded:
// 1x1 expand + relu6 -> 3x3 SAME depthwise + relu6 -> linear 1x1 project
// (+ residual), NHWC.
//
// Replaces: watsor_tpu/ops/fused_block.py fused_inverted_residual, the
// Pallas TPU kernel that runs 12 of MobileNetV2's 17 blocks under
// WATSOR_FUSED_BLOCKS=1.
//
// What bounds it on the H100: at batch 8 the 12 blocks of the main path do
// about 5.4 GFLOP of 1x1 products (5.4 us of bf16 tensor cores) and move
// about 17.6 MB (5.3 us of device memory): neither bound is near what a
// launch costs. What costs time is keeping 132 SMs busy on small images
// while the 6x-expanded activation stays on chip.
//
// The design (the second one; the first recomputed the expand for the halo
// rows of 1-, 2- or 4-row tiles and restaged every weight for every chunk):
//
// - A thread-block cluster of `cs` blocks shares one tile of output rows of
//   one image. Block `rank` of the cluster takes its own slice of the
//   expanded channels E (whole chunks of 16) and runs the whole block on it:
//   expand its slice over the tile's rows plus the one-row halo, depthwise,
//   and the slice's share of the projection. Parallelism now comes from E
//   as well as from rows, so tiles can be tall (a whole small image) and the
//   halo is recomputed on few rows, and every shape still fills the card.
// - The partial projections [pixels, C_out] in f32 are summed across the
//   cluster through distributed shared memory: each block sums a share of
//   the tile's pixels over the ranks in rank order 0..cs-1, so the result is
//   deterministic, and adds bias and residual on the way out.
// - The slice's weights are staged once per block with 16-byte cp.async in
//   two groups: x, the expand weights and bias first; the depthwise and
//   projection weights load while the expand runs.
// - Both 1x1 products run as mma.sync m16n8k16 (bf16 operands, f32 sums in
//   registers) fed by ldmatrix from rows padded to an odd number of 16-byte
//   units, so ldmatrix hits no bank twice. Bias and relu6 are applied in
//   registers before the bf16 store; a warp job covers 16 pixels x 64
//   channels over the whole reduction depth, so no sum goes through shared
//   memory until the f32 partial that the cluster reduces.
// - The depthwise pass runs a channel pair of one column a thread
//   (neighbouring threads on neighbouring pairs), walking down the tile
//   with the 3x3 window of bf16x2 taps and the pair's weights in
//   registers: three tap loads an output row instead of nine.
//
// The launch plan (rows per tile R, cluster size cs, shared memory bytes) is
// computed in Python (ops/fused_block.py plan_launch); this file computes
// the same layout and refuses a plan whose size disagrees. The rounding
// points are those of the TPU kernel: bf16 input, bf16 after expand
// (bias, relu6), bf16 after depthwise (bias, relu6), f32 out of the
// projection; only the order of f32 sums differs.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr size_t kMaxSmem = 227 * 1024;     // per-block limit on sm_90
constexpr int kMaxDevices = 64;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline int round_up(int v, int m) {
  return ceil_div(v, m) * m;
}
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Row stride in bf16 values for rows of k values: an odd number of 16-byte
// units, so the 8 rows an ldmatrix reads start in 8 different bank groups.
__host__ __device__ inline int bf16_stride(int k) {
  return (k / 8) % 2 ? k : k + 8;
}

__host__ __device__ inline size_t take(size_t* offset, size_t bytes) {
  const size_t at = *offset;
  *offset = (at + bytes + 127) / 128 * 128;
  return at;
}

// Shared-memory layout of one block; ops/fused_block.py _layout_bytes
// computes the same total.
struct Layout {
  int cin_p, cout_p, es_max, p_in_p, p_out_p;
  int sx, se, swp, spart;                   // row strides, in elements
  size_t xs, we, e, partial, d, wp, wdw, be, bdw, total;
};

__host__ __device__ inline Layout make_layout(int R, int H, int W, int Cin,
                                              int E, int Cout, int cs) {
  Layout l;
  l.cin_p = round_up(Cin, 16);
  l.cout_p = round_up(Cout, 16);
  l.es_max = ceil_div(E / 16, cs) * 16;     // the widest slice of E
  l.p_in_p = round_up(imin(R + 2, H) * W, 16);
  l.p_out_p = round_up(R * W, 16);
  l.sx = bf16_stride(l.cin_p);
  l.se = bf16_stride(l.es_max);
  l.swp = bf16_stride(l.cout_p);
  l.spart = l.cout_p + 4;
  size_t off = 0;
  // x, the expand weights and the expanded slice are dead once the
  // depthwise pass has run; the f32 partial projection reuses their space
  l.xs = take(&off, (size_t)l.p_in_p * l.sx * sizeof(bf16));
  l.we = take(&off, (size_t)l.cin_p * l.se * sizeof(bf16));
  l.e = take(&off, (size_t)l.p_in_p * l.se * sizeof(bf16));
  l.partial = 0;
  size_t partial_end = 0;
  take(&partial_end, (size_t)l.p_out_p * l.spart * sizeof(float));
  if (partial_end > off) off = partial_end;
  l.d = take(&off, (size_t)l.p_out_p * l.se * sizeof(bf16));
  l.wp = take(&off, (size_t)l.es_max * l.swp * sizeof(bf16));
  l.wdw = take(&off, 9 * (size_t)l.es_max * sizeof(bf16));
  l.be = take(&off, (size_t)l.es_max * sizeof(float));
  l.bdw = take(&off, (size_t)l.es_max * sizeof(float));
  l.total = off;
  return l;
}

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.f), 6.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment of m16n8k16: rows row0..row0+15 of a row-major bf16 tile.
__device__ __forceinline__ void ldsm_a(uint32_t a[4], const bf16* tile,
                                       int stride, int lane) {
  const bf16* p = tile + (lane & 15) * stride + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// B fragments of two n-tiles (16 columns) from a row-major [k][n] tile:
// b[0], b[1] for columns 0-7, b[2], b[3] for columns 8-15.
__device__ __forceinline__ void ldsm_b(uint32_t b[4], const bf16* tile,
                                       int stride, int lane) {
  const bf16* p = tile + (lane & 15) * stride + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp job: rows m0..m0+15 of A [*, K] times `pairs` (1 to 4) groups
// of 16 columns of B [K, *] from n0, f32 sums in registers.
__device__ __forceinline__ void warp_gemm(float acc[8][4], const bf16* a,
                                          int sa, const bf16* b, int sb,
                                          int K, int m0, int n0, int pairs,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; k += 16) {
    uint32_t af[4];
    ldsm_a(af, a + m0 * sa + k, sa, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < pairs) {
        uint32_t bfr[4];
        ldsm_b(bfr, b + k * sb + n0 + 16 * j, sb, lane);
        mma(acc[2 * j], af, bfr[0], bfr[1]);
        mma(acc[2 * j + 1], af, bfr[2], bfr[3]);
      }
    }
  }
}

__device__ __forceinline__ void stage_x(bf16* xs, const bf16* src, int p_in,
                                        int Cin, int sx, int tid) {
  const int q = Cin / 8;                    // 16-byte units a pixel
  for (int i = tid; i < p_in * q; i += kThreads) {
    const int p = i / q, j = i - p * q;
    cp_async16(xs + p * sx + j * 8, src + (size_t)p * Cin + j * 8);
  }
}

__device__ __forceinline__ void stage_x(bf16* xs, const float* src, int p_in,
                                        int Cin, int sx, int tid) {
  const int q = Cin / 4;
  for (int i = tid; i < p_in * q; i += kThreads) {
    const int p = i / q, j = i - p * q;
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)p * Cin) + j);
    bf162* dst = reinterpret_cast<bf162*>(xs + p * sx + j * 4);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// the bf16-rounded input, as f32 (the residual adds what the block read)
__device__ __forceinline__ float4 load_rounded4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load_rounded4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_float4(
      __bfloat162float(__float2bfloat16_rn(v.x)),
      __bfloat162float(__float2bfloat16_rn(v.y)),
      __bfloat162float(__float2bfloat16_rn(v.z)),
      __bfloat162float(__float2bfloat16_rn(v.w)));
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 raw;
  *reinterpret_cast<bf162*>(&raw.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<bf162*>(&raw.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// grid (ceil(H / R) * cs, B), clusters of (cs, 1, 1): cluster t works on
// output rows [t*R, t*R + R) of image blockIdx.y; its block of rank k on
// the chunks of 16 expanded channels [k*n/cs, (k+1)*n/cs), n = E / 16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const T* __restrict__ x, const bf16* __restrict__ we,
                   const float* __restrict__ be, const bf16* __restrict__ wdw,
                   const float* __restrict__ bdw, const bf16* __restrict__ wp,
                   const float* __restrict__ bp, T* __restrict__ out, int H,
                   int W, int Cin, int E, int Cout, int R, int cs,
                   int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = make_layout(R, H, W, Cin, E, Cout, cs);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);       // [p_in_p][sx]
  bf16* we_s = reinterpret_cast<bf16*>(smem + L.we);     // [cin_p][se]
  bf16* e_s = reinterpret_cast<bf16*>(smem + L.e);       // [p_in_p][se]
  float* part = reinterpret_cast<float*>(smem + L.partial);  // [p_out_p][spart]
  bf16* d_s = reinterpret_cast<bf16*>(smem + L.d);       // [p_out_p][se]
  bf16* wp_s = reinterpret_cast<bf16*>(smem + L.wp);     // [es_max][swp]
  bf16* wdw_s = reinterpret_cast<bf16*>(smem + L.wdw);   // [9][es_max]
  float* be_s = reinterpret_cast<float*>(smem + L.be);   // [es_max]
  float* bdw_s = reinterpret_cast<float*>(smem + L.bdw); // [es_max]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / cs) * R;
  const int rows = imin(R, H - r0);
  const int in_r0 = max(r0 - 1, 0);
  const int in_r1 = imin(r0 + rows + 1, H);
  const int p_in = (in_r1 - in_r0) * W;    // staged pixels, halo included
  const int p_out = rows * W;
  const int n_chunks = E / 16;
  const int e0 = rank * n_chunks / cs * 16;
  const int es = (rank + 1) * n_chunks / cs * 16 - e0;

  // group 0: the tile's input rows, the slice's expand weights and bias
  stage_x(xs, x + ((size_t)b * H + in_r0) * W * Cin, p_in, Cin, L.sx, tid);
  for (int i = tid; i < Cin * (es / 8); i += kThreads) {
    const int k = i / (es / 8), j = i - k * (es / 8);
    cp_async16(we_s + k * L.se + j * 8, we + (size_t)k * E + e0 + j * 8);
  }
  for (int i = tid; i < es / 4; i += kThreads)
    cp_async16(be_s + i * 4, be + e0 + i * 4);
  cp_async_commit();
  // group 1: depthwise weights and bias, the slice's projection rows
  for (int i = tid; i < 9 * (es / 8); i += kThreads) {
    const int t = i / (es / 8), j = i - t * (es / 8);
    cp_async16(wdw_s + t * L.es_max + j * 8,
               wdw + (size_t)t * E + e0 + j * 8);
  }
  for (int i = tid; i < es / 4; i += kThreads)
    cp_async16(bdw_s + i * 4, bdw + e0 + i * 4);
  for (int i = tid; i < es * (Cout / 8); i += kThreads) {
    const int c = i / (Cout / 8), j = i - c * (Cout / 8);
    cp_async16(wp_s + c * L.swp + j * 8,
               wp + (size_t)(e0 + c) * Cout + j * 8);
  }
  cp_async_commit();
  // zeros where the products read padding: input channels Cin..cin_p,
  // expand rows Cin..cin_p and projection columns Cout..cout_p (each pad
  // is 0 or 8 values, one 16-byte store a row). Pixels past p_in and
  // p_out feed only product rows that nothing reads.
  const uint4 zero16 = make_uint4(0, 0, 0, 0);
  if (Cin != L.cin_p) {
    for (int p = tid; p < p_in; p += kThreads)
      *reinterpret_cast<uint4*>(xs + p * L.sx + Cin) = zero16;
    for (int i = tid; i < (L.cin_p - Cin) * (es / 8); i += kThreads)
      *reinterpret_cast<uint4*>(we_s + (Cin + i / (es / 8)) * L.se +
                                i % (es / 8) * 8) = zero16;
  }
  if (Cout != L.cout_p)
    for (int c = tid; c < es; c += kThreads)
      *reinterpret_cast<uint4*>(wp_s + c * L.swp + Cout) = zero16;
  cp_async_wait<1>();
  __syncthreads();

  const int g = lane >> 2, t2 = (lane & 3) * 2;
  // expand: e[p_in, es] = relu6(x[p_in, cin_p] we[cin_p, es] + be), bf16
  {
    const int n_groups = ceil_div(es, 64);
    const int jobs = ceil_div(p_in, 16) * n_groups;
    for (int job = warp; job < jobs; job += kWarps) {
      const int m0 = job / n_groups * 16, n0 = job % n_groups * 64;
      const int pairs = imin(4, (es - n0) / 16);
      float acc[8][4];
      warp_gemm(acc, xs, L.sx, we_s, L.se, L.cin_p, m0, n0, pairs, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * pairs) break;
        const int c = n0 + nt * 8 + t2;
        const float b0 = be_s[c], b1 = be_s[c + 1];
        *reinterpret_cast<bf162*>(e_s + (m0 + g) * L.se + c) =
            __floats2bfloat162_rn(relu6(acc[nt][0] + b0),
                                  relu6(acc[nt][1] + b1));
        *reinterpret_cast<bf162*>(e_s + (m0 + g + 8) * L.se + c) =
            __floats2bfloat162_rn(relu6(acc[nt][2] + b0),
                                  relu6(acc[nt][3] + b1));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3x3 SAME depthwise: a thread keeps one channel pair's weights in
  // registers and walks columns of the tile, down each column with the 3x3
  // window of taps in registers, loading three taps a row; neighbouring
  // threads take neighbouring pairs. Taps sum in the TPU kernel's (row,
  // column) order; a tap outside the image is zero.
  {
    const int pairs = es / 2;
    const int lanes = imin(pairs, kThreads);      // threads across pairs
    const int columns = kThreads / lanes;          // columns at a time
    for (int cp = tid % lanes; tid < lanes * columns && cp < pairs;
         cp += lanes) {
      const int c = cp * 2;
      float2 k[9];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        k[t] = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(wdw_s + t * L.es_max + c));
      const float b0 = bdw_s[c], b1 = bdw_s[c + 1];
      for (int w = tid / lanes; w < W; w += columns) {
        // the taps of image row hh at columns w-1, w, w+1
        auto load_row = [&](float2 v[3], int hh) {
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const int ww = w + dc - 1;
            v[dc] = (hh >= 0 && hh < H && ww >= 0 && ww < W)
                        ? __bfloat1622float2(*reinterpret_cast<const bf162*>(
                              e_s + ((hh - in_r0) * W + ww) * L.se + c))
                        : make_float2(0.f, 0.f);
          }
        };
        float2 win[3][3];
        load_row(win[0], r0 - 1);
        load_row(win[1], r0);
        for (int r = 0; r < rows; ++r) {
          load_row(win[2], r0 + r + 1);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int dr = 0; dr < 3; ++dr)
#pragma unroll
            for (int dc = 0; dc < 3; ++dc) {
              s0 = fmaf(win[dr][dc].x, k[dr * 3 + dc].x, s0);
              s1 = fmaf(win[dr][dc].y, k[dr * 3 + dc].y, s1);
            }
          *reinterpret_cast<bf162*>(d_s + (r * W + w) * L.se + c) =
              __floats2bfloat162_rn(relu6(s0 + b0), relu6(s1 + b1));
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            win[0][dc] = win[1][dc];
            win[1][dc] = win[2][dc];
          }
        }
      }
    }
  }
  __syncthreads();

  // the slice's share of the projection: part[p_out, cout_p] =
  // d[p_out, es] wp[es, cout_p], f32
  {
    const int n_groups = ceil_div(L.cout_p, 64);
    const int jobs = ceil_div(p_out, 16) * n_groups;
    for (int job = warp; job < jobs; job += kWarps) {
      const int m0 = job / n_groups * 16, n0 = job % n_groups * 64;
      const int pairs = imin(4, (L.cout_p - n0) / 16);
      float acc[8][4];
      warp_gemm(acc, d_s, L.se, wp_s, L.swp, es, m0, n0, pairs, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= 2 * pairs) break;
        const int c = n0 + nt * 8 + t2;
        *reinterpret_cast<float2*>(part + (m0 + g) * L.spart + c) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(part + (m0 + g + 8) * L.spart + c) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
  cluster.sync();  // every rank's partial is written

  // this block's share of the tile's pixels: the ranks' partials summed in
  // rank order, then bias and residual
  {
    const int q = Cout / 4;
    const int pa = rank * p_out / cs, pb = (rank + 1) * p_out / cs;
    const size_t first = ((size_t)b * H + r0) * W;
    for (int i = tid; i < (pb - pa) * q; i += kThreads) {
      const int p = pa + i / q, co = (i % q) * 4;
      const int at = p * L.spart + co;
      // every rank's load in flight at once, then the sum in rank order
      float4 v[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < cs)
          v[r] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, r) + at);
      float4 s = v[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < cs) {
          s.x += v[r].x; s.y += v[r].y; s.z += v[r].z; s.w += v[r].w;
        }
      const float4 bias = *reinterpret_cast<const float4*>(bp + co);
      s.x += bias.x; s.y += bias.y; s.z += bias.z; s.w += bias.w;
      if (residual) {
        const float4 xr = load_rounded4(x + (first + p) * Cin + co);
        s.x += xr.x; s.y += xr.y; s.z += xr.z; s.w += xr.w;
      }
      store4(out + (first + p) * Cout + co, s);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
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
                   int E, int Cout, int residual, int R, int cs, int smem,
                   int device, cudaStream_t stream) {
  if (R < 1 || R > H || cs < 1 || cs > kMaxCluster || cs > E / 16)
    return cudaErrorInvalidValue;
  const Layout L = make_layout(R, H, W, Cin, E, Cout, cs);
  if (L.total != (size_t)smem || L.total > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_max_smem<T>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ceil_div(H, R) * cs, B, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = L.total;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cs;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, fused_block_kernel<T>, x, we, be, wdw, bdw, wp, bp, out, H,
      W, Cin, E, Cout, R, cs, residual);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

}  // namespace

// x, out [B, H, W, C] NHWC contiguous, bf16 (x_is_bf16 = 1) or f32;
// we [Cin, E], wdw [3, 3, E], wp [E, Cout] bf16; be [E], bdw [E], bp [Cout]
// f32. Cin and Cout multiples of 8, E of 16; residual requires Cin == Cout.
// (R, cs, smem) is the launch plan of ops/fused_block.py plan_launch.
// `device` is the stream's device. Returns a cudaError_t (0 = launched).
extern "C" int wt_fused_inverted_residual(
    const void* x, int x_is_bf16, const void* we, const float* be,
    const void* wdw, const float* bdw, const void* wp, const float* bp,
    void* out, int B, int H, int W, int Cin, int E, int Cout, int residual,
    int R, int cs, int smem, int device, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || E <= 0 || Cout <= 0 ||
      B > 65535 || Cin % 8 || Cout % 8 || E % 16 ||
      (residual && Cin != Cout))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return guard.error;
  const bf16* we_ = static_cast<const bf16*>(we);
  const bf16* wdw_ = static_cast<const bf16*>(wdw);
  const bf16* wp_ = static_cast<const bf16*>(wp);
  if (x_is_bf16)
    return launch(static_cast<const bf16*>(x), we_, be, wdw_, bdw, wp_, bp,
                  static_cast<bf16*>(out), B, H, W, Cin, E, Cout, residual,
                  R, cs, smem, device, stream);
  return launch(static_cast<const float*>(x), we_, be, wdw_, bdw, wp_, bp,
                static_cast<float*>(out), B, H, W, Cin, E, Cout, residual, R,
                cs, smem, device, stream);
}
