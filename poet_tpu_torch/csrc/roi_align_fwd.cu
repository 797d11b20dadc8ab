// Multi-scale RoIAlign, forward — CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel poet_tpu/ops/roi_align_pallas.py:_kernel (reached
// from multiscale_roi_align_pallas and its wide-box re-pool), the Mask R-CNN
// box head's pooling on the detect+pose path. It computes torchvision
// MultiScaleRoIAlign with aligned=False: each box pools a 7x7 grid of bins
// from the one pyramid level its scale selects, each bin the mean of 2x2
// bilinear samples.
//
// The geometry is NOT computed here. The wrapper
// (poet_tpu_torch/ops/roi_align_cuda.py) computes, in torch and shared with
// the plain version, each box's level and per sample of each axis the lower
// corner and the two corner weights (zero for a sample outside the map).
// The level choice (floor of a log2) and the cell a sample coordinate
// floors to are discontinuous, and nvcc contracts a*b+c into an FMA by
// default, so coordinates computed in-kernel could land in another cell or
// level than torch's on the CPU. The kernels only gather and blend.
//
//   level_ptrs[l]  (B, H_l, W_l, C)   f32 or bf16, one pointer per level
//   level          (BR,)              int32, the box's level index
//   ylo, xlo       (BR, N)            int32, lower corner per sample, N = out * s
//   yw, xw         (BR, N, 2)         f32, weights of the lower and upper corner
//   out            (BR, out, out, C)  features' dtype, summed in f32, rounded once
//
// The TPU kernel's VMEM-resident pyramid, 8-aligned x-window and x-weight
// matmul exist because the TPU has no fast gather; they are not carried
// over, and so there are no x-window violators and no re-pool loop.
//
// What bounds it: bytes. The function reads the feature cells the boxes
// touch once and writes 401 MB of pooled bins (16 x 1000 x 7 x 7 x 256
// bf16): ~182 us at 3.35 TB/s, against ~6.4 GFLOP of blending (~96 us at
// 67 TFLOP/s f32). Two routes, chosen by the wrapper's written rule
// (ops/roi_align_cuda.py:plan_roi):
//
// TILES (roi_align_tiles_kernel), wherever a box's worst footprint fits a
// block's shared memory at one 16-byte channel slice: one block per box.
// The box's samples touch at most 2N distinct rows (each sample's y0 and
// y0 + 1) and 2N distinct columns; the block finds them once (a rank among
// the distinct candidates, no sort), then walks C in chunks: it stages
// exactly those rows x columns cells of a chunk into shared memory once, by
// 16-byte cp.async into one of two buffers (the next chunk's copies fly
// while this one is blended), and blends separably: per bin an x-pass over the bin's
// staged rows (its samples' columns, their weights merged per column) and
// a y-pass over those partial sums (the weights merged per row). A bin's s
// samples touch at most 2s consecutive staged rows (the geometry's
// coordinates rise with the sample index), so a bin reads its (2s)^2 = 16
// cell window from shared memory, where the gather route reads 16 corners
// per bin from the L2; from the L2 the box's cells come once (256 a box on
// average at the detect+pose shape, against 784 corner reads). The f32 sum
// stays in registers; the bin is stored once, 16 bytes a thread. Each
// buffer is sized for the worst footprint, (2N)^2 cells x chunk channels
// (25 088 B at N = 14, 16 bf16 channels): the rule cuts C into chunks that
// fit (tests/test_torch_roi_align_tiles.py). Measured, it is bound by
// latency, not bytes: each chunk's copies are waited for and each chunk
// costs two block barriers (2.0 TB/s of staged bytes on an H100).
//
// GATHER (roi_align_fwd_kernel), for footprints over the budget: one thread
// per (box, bin, 16-byte channel slice) reads its 4 samples x 4 corners
// from the L2 (16x the output bytes).
//
// A sample outside the map (both weights zero) reads nothing on either
// route; a NaN box's samples are all outside, so it pools zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma_sm90.cuh"

#define POET_ROI_MAX_LEVELS 8
#define POET_ROI_MAX_N 32     // samples per axis on the tiles route: out * s
#define POET_ROI_MAX_OUT 16   // bins per axis on the tiles route
#define POET_ROI_MAX_S 4      // samples per bin and axis on the tiles route
#define POET_ROI_MAX_WIN (2 * POET_ROI_MAX_S)   // staged lines one bin touches

namespace {

struct Levels {
  const void* ptr[POET_ROI_MAX_LEVELS];
  int h[POET_ROI_MAX_LEVELS];
  int w[POET_ROI_MAX_LEVELS];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// acc[0:VEC] += w * p[0:VEC]
template <typename T, int VEC>
struct Vec {
  static __device__ __forceinline__ void fma(const T* p, float w, float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += w * to_float(p[j]);
  }
  static __device__ __forceinline__ void store(T* p, const float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_float<T>(acc[j]);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void fma(const float* p, float w, float* acc) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void fma(const __nv_bfloat16* p, float w, float* acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      acc[2 * j] += w * f.x;
      acc[2 * j + 1] += w * f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* acc) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h2[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// One thread per (box, oy, ox, c): c indexes a VEC-wide slice of the C
// channels. Consecutive threads walk c, then ox, so a warp covers the
// channels of one bin (C = 256 bf16) or of neighbouring bins.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
roi_align_fwd_kernel(Levels lv, int L, const int* __restrict__ level,
                     const int* __restrict__ ylo, const float2* __restrict__ yw,
                     const int* __restrict__ xlo, const float2* __restrict__ xw,
                     T* __restrict__ out, int R, int C, int out_size, int s, int64_t n_items) {
  const int chunks = C / VEC;
  const int N = out_size * s;
  const float inv_count = 1.f / (float)(s * s);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chunks);
    const int64_t bin = i / chunks;                 // (r * out + oy) * out + ox
    const int ox = (int)(bin % out_size);
    const int oy = (int)((bin / out_size) % out_size);
    const int64_t r = bin / ((int64_t)out_size * out_size);
    const int l = min(max(level[r], 0), L - 1);
    const int Hl = lv.h[l];
    const int Wl = lv.w[l];
    const int64_t b = r / R;
    const T* f = static_cast<const T*>(lv.ptr[l]) + b * Hl * Wl * C + c * VEC;

    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;

    for (int ky = 0; ky < s; ++ky) {
      const int64_t ny = r * N + oy * s + ky;
      const float2 wy = yw[ny];
      if (wy.x == 0.f && wy.y == 0.f) continue;     // outside the map: reads nothing
      const int y0 = min(max(ylo[ny], 0), Hl - 2);
      const T* row0 = f + (int64_t)y0 * Wl * C;
      const T* row1 = row0 + (int64_t)Wl * C;
      for (int kx = 0; kx < s; ++kx) {
        const int64_t nx = r * N + ox * s + kx;
        const float2 wx = xw[nx];
        if (wx.x == 0.f && wx.y == 0.f) continue;
        const int x0 = min(max(xlo[nx], 0), Wl - 2);
        const int64_t o0 = (int64_t)x0 * C;
        const int64_t o1 = o0 + C;
        Vec<T, VEC>::fma(row0 + o0, wy.x * wx.x, acc);
        Vec<T, VEC>::fma(row0 + o1, wy.x * wx.y, acc);
        Vec<T, VEC>::fma(row1 + o0, wy.y * wx.x, acc);
        Vec<T, VEC>::fma(row1 + o1, wy.y * wx.y, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] *= inv_count;
    Vec<T, VEC>::store(out + bin * C + c * VEC, acc);
  }
}

template <typename T, int VEC>
void launch(const Levels& lv, int L, const int* level, const int* ylo, const float* yw,
            const int* xlo, const float* xw, void* out, int B, int R, int C, int out_size,
            int s, cudaStream_t stream) {
  const int64_t n_items = (int64_t)B * R * out_size * out_size * (C / VEC);
  if (n_items == 0) return;
  const int threads = 256;
  int64_t blocks = (n_items + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride beyond
  roi_align_fwd_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      lv, L, level, ylo, reinterpret_cast<const float2*>(yw), xlo,
      reinterpret_cast<const float2*>(xw), static_cast<T*>(out), R, C, out_size, s, n_items);
}

// ------------------------------------------------------------------ tiles
constexpr int kTileThreads = 256;

// One axis of a box on the tiles route, in shared memory: the distinct
// lines (rows or columns) its in-map samples touch, ascending, and per bin
// the first of its lines and the weight of each of its at most 2s lines.
struct Axis {
  int cand[2 * POET_ROI_MAX_N];           // sample i / 2's line lo + i % 2, or INT_MAX
  unsigned char first[2 * POET_ROI_MAX_N];// cand[i] is the first of its value
  int line[2 * POET_ROI_MAX_N];           // the k-th staged line
  int idx[POET_ROI_MAX_N];                // sample n's lower line, an index into line[]
  int n;                                  // lines staged
  int start[POET_ROI_MAX_OUT];            // bin o's first line index
  float w[POET_ROI_MAX_OUT][POET_ROI_MAX_WIN];  // bin o's weight of line start + j
};

// The staging plan of one axis, by the block's threads t in [0, 2N) (the
// candidates) and [0, out) (the bins), from the geometry's lo (N) and
// weights (N x 2). Candidate i is a line of sample i / 2 if that sample is
// in the map (a weight non-zero); its rank among the distinct candidates
// is its index in line[]. Each step is called by all threads (t < 0 or t
// >= 2N do nothing), with a __syncthreads between steps.
__device__ __forceinline__ void axis_candidates(Axis& a, const int* lo, const float2* w,
                                                int N, int size, int t) {
  if (t >= 0 && t < 2 * N) {
    const int n = t >> 1;
    const float2 wn = w[n];
    const bool in = wn.x != 0.f || wn.y != 0.f;
    a.cand[t] = in ? min(max(lo[n], 0), size - 2) + (t & 1) : INT_MAX;
  }
}

__device__ __forceinline__ void axis_firsts(Axis& a, int N, int t) {
  if (t >= 0 && t < 2 * N) {
    const int v = a.cand[t];
    bool first = v != INT_MAX;
    for (int k = 0; k < t && first; ++k) first = a.cand[k] != v;
    a.first[t] = first;
  }
}

__device__ __forceinline__ void axis_ranks(Axis& a, int N, int t) {
  if (t >= 0 && t < 2 * N) {
    const int v = a.cand[t];
    int rank = 0;
    for (int k = 0; k < 2 * N; ++k) rank += (a.first[k] && a.cand[k] < v) ? 1 : 0;
    if (a.first[t]) a.line[rank] = v;
    if ((t & 1) == 0 && v != INT_MAX) a.idx[t >> 1] = rank;
    if (t == 0) {
      int n = 0;
      for (int k = 0; k < 2 * N; ++k) n += a.first[k];
      a.n = n;
    }
  }
}

// Bin o's lines: its in-map samples' lower lines idx and idx + 1, each
// weight merged into the line's slot. The samples rise with their index,
// so the bin's lines are consecutive in line[] and at most 2s of them.
__device__ __forceinline__ void axis_bin(Axis& a, const float2* w, int s, int o) {
  int start = INT_MAX;
  for (int k = 0; k < s; ++k) {
    const float2 wn = w[o * s + k];
    if (wn.x != 0.f || wn.y != 0.f) start = min(start, a.idx[o * s + k]);
  }
#pragma unroll
  for (int j = 0; j < POET_ROI_MAX_WIN; ++j) a.w[o][j] = 0.f;
  a.start[o] = start == INT_MAX ? 0 : start;
  for (int k = 0; k < s; ++k) {
    const float2 wn = w[o * s + k];
    if (wn.x == 0.f && wn.y == 0.f) continue;
    const int j = a.idx[o * s + k] - start;
    a.w[o][j] += wn.x;
    a.w[o][j + 1] += wn.y;
  }
}

// One blended bin slice, acc[0:VEC] = sum over the bin's rows j and columns
// i of wy[j] wx[i] tile[row j, column i], from the staged tile. With SS > 0
// (the sampling ratio known at compile time) the 2 SS x 2 SS window is read
// unrolled, every load independent: lines past the staged ones are clamped
// onto the last (weight 0); otherwise the window is walked at run time,
// skipping the lines of weight 0.
template <typename T, int VEC, int SS>
__device__ __forceinline__ void blend_bin(const T* tile, const Axis& ay, const Axis& ax, int oy,
                                          int ox, int ny, int nx, int CC, int win, float* acc) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  if constexpr (SS > 0) {
    constexpr int W = 2 * SS;
    int col[W];
    float wx[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      col[i] = min(ax.start[ox] + i, nx - 1) * CC;
      wx[i] = ax.w[ox][i];
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const T* row = tile + (int64_t)min(ay.start[oy] + j, ny - 1) * nx * CC;
      float xr[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) xr[v] = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) Vec<T, VEC>::fma(row + col[i], wx[i], xr);
      const float wy = ay.w[oy][j];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += wy * xr[v];
    }
  } else {
    const T* base = tile + ((int64_t)ay.start[oy] * nx + ax.start[ox]) * CC;
    for (int j = 0; j < win; ++j) {
      const float wy = ay.w[oy][j];
      if (wy == 0.f) continue;                // no sample of the bin on this row
      const T* row = base + (int64_t)j * nx * CC;
      float xr[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) xr[v] = 0.f;
      for (int i = 0; i < win; ++i) {
        const float wx = ax.w[ox][i];
        if (wx == 0.f) continue;
        Vec<T, VEC>::fma(row + i * CC, wx, xr);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += wy * xr[v];
    }
  }
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One block per box (blockIdx.x). Dynamic shared memory: the element
// offset in the box's level of each staged cell ((2N)^2 ints), then two
// buffers of the staged cells of one channel chunk, line_y[r] x line_x[c]
// at (r * nx + c) * CC, CC channels each; the two axes' plans are static.
// The block plans the box once, then walks C in chunks of CC channels: the
// copies of chunk k + 1 are in flight while chunk k is blended. With
// async16, a cell's chunk is 2^per_shift 16-byte pieces.
template <typename T, int VEC, int SS>
__global__ void __launch_bounds__(kTileThreads)
roi_align_tiles_kernel(Levels lv, int L, const int* __restrict__ level,
                       const int* __restrict__ ylo, const float2* __restrict__ yw,
                       const int* __restrict__ xlo, const float2* __restrict__ xw,
                       T* __restrict__ out, int R, int C, int CC, int out_size, int s,
                       bool async16, int per_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Axis ay, ax;
  const int64_t box = blockIdx.x;
  const int l = min(max(level[box], 0), L - 1);
  const int Hl = lv.h[l];
  const int Wl = lv.w[l];
  const int N = out_size * s;
  const int t = threadIdx.x;
  const int* yl = ylo + box * N;
  const int* xl = xlo + box * N;
  const float2* ywb = yw + box * N;
  const float2* xwb = xw + box * N;

  axis_candidates(ay, yl, ywb, N, Hl, t);
  axis_candidates(ax, xl, xwb, N, Wl, t - 2 * N);
  __syncthreads();
  axis_firsts(ay, N, t);
  axis_firsts(ax, N, t - 2 * N);
  __syncthreads();
  axis_ranks(ay, N, t);
  axis_ranks(ax, N, t - 2 * N);
  __syncthreads();
  if (t < out_size) axis_bin(ay, ywb, s, t);
  else if (t < 2 * out_size) axis_bin(ax, xwb, s, t - out_size);

  const int ny = ay.n, nx = ax.n;
  const int cells = ny * nx;
  const int max_cells = (2 * N) * (2 * N);
  int* cell_off = reinterpret_cast<int*>(smem);
  for (int c = t; c < cells; c += blockDim.x) {
    const int r = c / nx;
    cell_off[c] = (ay.line[r] * Wl + ax.line[c - r * nx]) * C;
  }
  __syncthreads();
  T* const buf = reinterpret_cast<T*>(smem + (((size_t)max_cells * sizeof(int) + 15) &
                                               ~(size_t)15));
  const int64_t buf_elems = (int64_t)max_cells * CC;   // two buffers of buf_elems
  const int slices = CC / VEC;
  T* const out_box = out + box * out_size * out_size * C;
  if (cells == 0) {                           // every sample off the map (a NaN box): zeros
    const float zero[VEC] = {};
    for (int it = t; it < out_size * out_size * (C / VEC); it += blockDim.x)
      Vec<T, VEC>::store(out_box + (int64_t)it * VEC, zero);
    return;
  }
  const T* f = static_cast<const T*>(lv.ptr[l]) + (box / R) * Hl * Wl * C;
  // the box's footprint cells of channels c0 .. c0 + CC - 1 into `dst`
  auto stage = [&](int c0, T* dst) {
    if (async16) {
      constexpr int E = 16 / sizeof(T);
      const int mask = (1 << per_shift) - 1;
      for (int i = t; i < (cells << per_shift); i += blockDim.x)
        mma_sm90::cp_async16(dst + (int64_t)i * E,
                             f + cell_off[i >> per_shift] + c0 + (i & mask) * E, true);
    } else {
      for (int i = t; i < cells * CC; i += blockDim.x) {
        const int cell = i / CC;
        dst[i] = f[cell_off[cell] + c0 + (i - cell * CC)];
      }
    }
    mma_sm90::cp_async_commit();
  };

  const int chunks = C / CC;
  const float inv_count = 1.f / (float)(s * s);
  stage(0, buf);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage((k + 1) * CC, buf + ((k + 1) & 1) * buf_elems);
      cp_async_wait_one();                    // chunk k has landed, k + 1 in flight
    } else {
      mma_sm90::cp_async_wait_all();
    }
    __syncthreads();
    const T* tile = buf + (k & 1) * buf_elems;
    // blend: thread item = (oy, ox, slice), the slice fastest
    for (int it = t; it < out_size * out_size * slices; it += blockDim.x) {
      const int slice = it % slices;
      const int bin = it / slices;
      float acc[VEC];
      blend_bin<T, VEC, SS>(tile + slice * VEC, ay, ax, bin / out_size, bin % out_size, ny, nx,
                            CC, 2 * s, acc);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] *= inv_count;
      Vec<T, VEC>::store(out_box + (int64_t)bin * C + k * CC + slice * VEC, acc);
    }
    __syncthreads();                          // buffer k & 1 is free for chunk k + 2
  }
}

// the tiles route's dynamic shared memory: the cell offsets and two buffers
// of the worst footprint, (2N)^2 cells of CC channels
size_t tiles_smem_bytes(int N, int CC, size_t itemsize) {
  const size_t cells = (size_t)(2 * N) * (2 * N);
  return ((cells * sizeof(int) + 15) & ~(size_t)15) + 2 * cells * CC * itemsize;
}

constexpr int kMaxDevices = 64;

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device: 0, -7 over the device's opt-in limit, or a cudaError_t. The
// attribute is set once per device and size (`granted`), so a call captured
// into a CUDA graph makes no attribute call.
template <typename K>
int grant_smem(K kernel, size_t smem, size_t* granted) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return -7;
  if (dev >= kMaxDevices) return -8;
  if (smem > 48 * 1024 && smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = smem;
  }
  return 0;
}

template <typename T, int VEC, int SS>
int launch_tiles(const Levels& lv, int L, const int* level, const int* ylo, const float* yw,
                 const int* xlo, const float* xw, void* out, int B, int R, int C, int CC,
                 int out_size, int s, int threads, cudaStream_t stream) {
  const int64_t blocks = (int64_t)B * R;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return -6;
  const size_t smem = tiles_smem_bytes(out_size * s, CC, sizeof(T));
  auto kernel = roi_align_tiles_kernel<T, VEC, SS>;
  static size_t granted[kMaxDevices];  // per instantiation
  const int rc = grant_smem(kernel, smem, granted);
  if (rc != 0) return rc;
  // 16-byte copies where a cell's chunk is a power of two of 16-byte pieces
  const int pieces = (int)(CC * sizeof(T) / 16);
  bool async16 = (CC * sizeof(T)) % 16 == 0 && (C * sizeof(T)) % 16 == 0 &&
                 (pieces & (pieces - 1)) == 0;
  for (int l = 0; l < L; ++l)
    async16 = async16 && reinterpret_cast<uintptr_t>(lv.ptr[l]) % 16 == 0;
  int per_shift = 0;
  while ((1 << per_shift) < pieces) ++per_shift;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      lv, L, level, ylo, reinterpret_cast<const float2*>(yw), xlo,
      reinterpret_cast<const float2*>(xw), static_cast<T*>(out), R, C, CC, out_size, s, async16,
      per_shift);
  return (int)cudaGetLastError();
}

// the launch for a sampling ratio: s = 2 (the detector's) unrolled, any
// other walked at run time
template <typename T, int VEC>
int launch_tiles_s(const Levels& lv, int L, const int* level, const int* ylo, const float* yw,
                   const int* xlo, const float* xw, void* out, int B, int R, int C, int CC,
                   int out_size, int s, int threads, cudaStream_t stream) {
  if (s == 2)
    return launch_tiles<T, VEC, 2>(lv, L, level, ylo, yw, xlo, xw, out, B, R, C, CC, out_size, s,
                                   threads, stream);
  return launch_tiles<T, VEC, 0>(lv, L, level, ylo, yw, xlo, xw, out, B, R, C, CC, out_size, s,
                                 threads, stream);
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   level_ptrs: host array of L device pointers, level l is (B, H_l, W_l, C)
//   level_hw:   host array of 2*L ints, (H_l, W_l) per level
//   dtype:      0 = float32, 1 = bfloat16
//   vec:        channels per thread, 1 or the 16-byte width (4 f32, 8 bf16)
int poet_roi_align_fwd(const void* const* level_ptrs, const int* level_hw, int L,
                       const void* level, const void* ylo, const void* yw, const void* xlo,
                       const void* xw, void* out, int dtype, int B, int R, int C,
                       int out_size, int sampling_ratio, int vec, void* stream) {
  if (L < 1 || L > POET_ROI_MAX_LEVELS) return -1;
  if (vec < 1 || C % vec != 0) return -2;
  if (out_size < 1 || sampling_ratio < 1) return -3;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 2 || lv.w[l] < 2) return -4;   // bilinear corners need 2x2
  }
  const int* lvl = static_cast<const int*>(level);
  const int* yl = static_cast<const int*>(ylo);
  const int* xl = static_cast<const int*>(xlo);
  const float* ywf = static_cast<const float*>(yw);
  const float* xwf = static_cast<const float*>(xw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = sampling_ratio;
  if (dtype == 0 && vec == 4) {
    launch<float, 4>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else if (dtype == 0 && vec == 1) {
    launch<float, 1>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else if (dtype == 1 && vec == 8) {
    launch<__nv_bfloat16, 8>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else if (dtype == 1 && vec == 1) {
    launch<__nv_bfloat16, 1>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, out_size, s, st);
  } else {
    return -5;
  }
  return (int)cudaGetLastError();
}

// The tiles route: same arguments as poet_roi_align_fwd plus `chunk`, the
// channels of one staged chunk (C % chunk == 0, chunk % vec == 0), and
// `threads` per block (a multiple of 32, 4 N to 256). -3 for an output grid
// or sampling ratio past the route's limits, -7 when the worst footprint's
// shared memory exceeds the device's opt-in limit.
int poet_roi_align_tiles(const void* const* level_ptrs, const int* level_hw, int L,
                         const void* level, const void* ylo, const void* yw, const void* xlo,
                         const void* xw, void* out, int dtype, int B, int R, int C,
                         int out_size, int sampling_ratio, int vec, int chunk, int threads,
                         void* stream) {
  if (L < 1 || L > POET_ROI_MAX_LEVELS) return -1;
  if (vec < 1 || chunk < vec || C % chunk != 0 || chunk % vec != 0) return -2;
  if (out_size < 1 || sampling_ratio < 1 || out_size > POET_ROI_MAX_OUT ||
      sampling_ratio > POET_ROI_MAX_S || out_size * sampling_ratio > POET_ROI_MAX_N)
    return -3;
  if (threads % 32 != 0 || threads > kTileThreads || threads < 4 * out_size * sampling_ratio)
    return -3;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.ptr[l] = level_ptrs[l];
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    if (lv.h[l] < 2 || lv.w[l] < 2) return -4;
    if ((int64_t)lv.h[l] * lv.w[l] * C > INT_MAX) return -4;   // the cells' int offsets
  }
  const int* lvl = static_cast<const int*>(level);
  const int* yl = static_cast<const int*>(ylo);
  const int* xl = static_cast<const int*>(xlo);
  const float* ywf = static_cast<const float*>(yw);
  const float* xwf = static_cast<const float*>(xw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = sampling_ratio;
#define POET_TILES(T, V)                                                                  \
  return launch_tiles_s<T, V>(lv, L, lvl, yl, ywf, xl, xwf, out, B, R, C, chunk, out_size, s, \
                              threads, st)
  if (dtype == 0 && vec == 4) POET_TILES(float, 4);
  if (dtype == 0 && vec == 1) POET_TILES(float, 1);
  if (dtype == 1 && vec == 8) POET_TILES(__nv_bfloat16, 8);
  if (dtype == 1 && vec == 1) POET_TILES(__nv_bfloat16, 1);
#undef POET_TILES
  return -5;
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
