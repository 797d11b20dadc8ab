// Fused small-C "stem" convolution, forward — CUDA for Hopper (sm_90a),
// an implicit GEMM on the tensor cores (mma.sync).
//
// Replaces the TPU kernel poet_tpu/ops/conv_stem_pallas.py:_kernel (reached
// from conv_stem_pallas), the darknet body's entry convolutions on the
// YOLOv4-CSP detect+pose path (3x3/1 3->32, 3x3/2 32->64, 3x3/1 32->64 at
// 480x640 and 240x320) and the ResNet 7x7/2 stem's function. It computes
// conv_stem_pallas's contract, not its TPU layout:
//
//   x     (B, H, W, C)   NHWC, f32 or bf16
//   w     (kh, kw, C, F) HWIO, x's dtype (FrozenBN already folded in)
//   bias  (F,)           f32, or null
//   out   (B, Ho, Wo, F) f32 or bf16, Ho = (H + pt + pb - kh) / s + 1
//   out = act(sum over (ky, kx, c) of x_pad[oy*s + ky, ox*s + kx, c] * w[ky, kx, c, f]
//             + bias[f]), summed in f32, the activation in f32 (none, relu,
//             the one-exp mish of models/yolov4.py, leaky 0.1), rounded once.
//
// The GEMM: M = output pixels, N = output channels, K = kh*kw*C ordered
// tap-major (ky, kx, c), as the HWIO weights lie in memory.
//   * bf16: mma.sync m16n8k16 bf16 -> f32. The products are exact in f32.
//   * f32: mma.sync m16n8k8 TF32 in the 3xTF32 split (hi = tf32(v), lo =
//     tf32(v - hi) on both sides; hi*hi into one accumulator, hi*lo + lo*hi
//     into an accumulator of their own, which the tensor cores would
//     otherwise truncate away at the big sum's magnitude). Every dtype goes
//     through the tensor cores; there is no SIMT body.
// f32's two accumulators join an f32 total on the SIMT pipes (round to
// nearest) after every tap (every 4 k-steps without the direct A path), so
// the tensor cores' truncating adds act on a few steps, not on all of K;
// bf16 sums all of K in the mma's accumulator (18 steps at most on the path:
// the truncation stays under 18 x 2^-23 of the sum, well inside the bf16
// output's rounding).
//
// What bounds it: bytes. The three YOLO launches at B=16 480x640 move 1052
// MB of bf16 (each input read once, each output written once): 0.314 ms at
// 3.35 TB/s, against 99 GFLOP, 0.10 ms at 989 TFLOP/s bf16. What the design
// does about it:
//   * blocks of 8 warps, each on one chunk of up to 64 output channels: on
//     the direct path persistent, as many as are resident at once, walking
//     the 8 x 16 output-pixel tiles; on the im2col path one per tile (its
//     plain-load staging overlaps only other blocks). Warp w owns output
//     row w of a tile (an m16 tile) and the whole chunk (NT = chunk / 8 n8
//     tiles);
//   * the chunk's folded weights (K x chunk, at most 288 x 64 bf16 = 36 KB
//     on the path) are staged once per block, rows padded by 8 elements; B
//     comes from them by ldmatrix.trans (bf16: 8 row addresses on 8 bank
//     groups) or two 4-byte loads (TF32: the 32 lanes on 32 banks);
//   * each tile's input and halo ((8-1)*s + kh rows, (16-1)*s + kw
//     columns, all C) are staged once; where a second tile buffer fits
//     without costing a resident block (L3, not L1: with two buffers L1 ran
//     one block of 8 warps per SM and took 0.83 ms in phase 12, against
//     0.61 with two blocks), the next tile's copy is issued before this
//     tile's products, so it lands while they run;
//   * the direct A path (C a multiple of the mma depth: 16 bf16 or 8 f32;
//     L1 and L3): 16-byte cp.async copies whose zero-fill form (src-size 0)
//     writes the padding outside the image. Columns are stored by stride
//     phase (column ix at slot (ix % s) * ceil(cols / s) + ix / s), so that
//     neighbouring output pixels are neighbouring slots at stride 2 too, and
//     each pixel's channels are padded by 16 bytes: ldmatrix then reads the A
//     fragment straight from the tile, one row address per pixel, the 8 of a
//     matrix on 8 different 16-byte bank groups;
//   * the im2col path (small C; L0: C = 3, K = 27): a warp stages a tile row
//     as the contiguous span of x it is (element by element, zeros outside
//     the image; C = 3 rows are not 16-byte vectors), then the block builds a
//     128 x K tile in shared memory, K padded to the mma depth with zeros
//     (27 -> 32), rows padded by 16 bytes, and ldmatrix reads that. The
//     tile offset of (pixel, k) separates into base(pixel) + koff[k], koff
//     a table of Kp ints, so the build divides by nothing per element;
//   * the epilogue adds the bias and applies the activation in f32 on the
//     accumulator fragments and rounds once to the output dtype. The
//     weights' columns are staged in an order (channel_of_column) that gives
//     each thread consecutive channels of its pixels, so they leave in
//     16-byte stores (8 bytes for a group of 2 n8 tiles) straight from the
//     registers, the 4 threads of a pixel on one contiguous run; ragged
//     tiles, channels past F and F not a multiple of 8 are masked.
// A shared-memory request above 48 KB is granted with cudaFuncSetAttribute;
// one above the card's 227 KB is refused (the wrapper raises).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "activations.cuh"
#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;
using namespace poet_act;

constexpr int TH = 8;              // output rows per tile (one warp each)
constexpr int TW = 16;             // output columns per tile (one m16 tile)
constexpr int THREADS = TH * 32;
constexpr int MAX_CHUNK = 64;      // output channels per block
constexpr int W_PAD = 8;           // elements added to each staged weight row (banks)
constexpr int FLUSH_STEPS = 4;     // k-steps per join of the im2col path
constexpr int MAX_SMEM = 232448;   // bytes a block may use on sm_90

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

struct Geometry {
  int B, H, W, C, F, kh, kw, s, pt, pl, Ho, Wo, act;
  int chunk, n_chunks;            // output channels of a block (a multiple of 16)
  int nty, ntx, n_tiles;          // 8 x 16 output tiles: per image row and column, in all
  int rows_in, cols_in, colsp;    // the staged tile; colsp = ceil(cols_in / s)
  int pitch;                      // staged pixels per tile row (s * colsp direct, cols_in im2col)
  int cs;                         // elements per staged pixel (C, + 16 bytes on the direct path)
  int K, Kp;                      // K = kh kw C; Kp = K padded to the mma depth (im2col path)
  int as;                         // elements per im2col row (Kp + 16 bytes)
  int ws;                         // elements per staged weight row (chunk + W_PAD)
  int tile_bytes, n_buf;          // one staged tile; 2 buffers where both fit, else 1
  int tile_off, a_off, koff_off;  // byte offsets of the tiles, the im2col tile, its k table
  int vec_out, out_bf16;
};

// Tile column ix -> its slot in a staged row of the direct path (stride
// phase major; the im2col path stores columns in order).
__device__ __forceinline__ int col_slot(int ix, int s, int colsp) {
  return (ix % s) * colsp + ix / s;
}

// The output channel (within the chunk) of mma column j = 8 n + 2 t + c.
// The chunk's words (channel pairs) of thread t are stored in groups of 4
// n8 tiles: group q holds the wq = min(4, NT - 4q) tiles 4q.., and gives
// thread t the 2 wq consecutive channels 32 q + 2 wq t .. , so that its
// accumulators leave as whole 16-byte (or 8-byte) vectors and the 4 threads
// of a row cover a contiguous run of the pixel's channels.
__device__ __forceinline__ int channel_of_column(int j, int NT) {
  const int n = j >> 3, t = (j >> 1) & 3, c = j & 1;
  const int q = n >> 2, wq = min(4, NT - 4 * q);
  return 32 * q + 2 * wq * t + 2 * (n - 4 * q) + c;
}

// A block walks the 8 x 16 output tiles t = blockIdx.x, + gridDim.x, ... of
// channel chunk blockIdx.y (one tile each on the im2col path). T: the input
// dtype; NT: n8 tiles per warp (chunk / 8); DIRECT: A from the staged tile
// (C a multiple of the mma depth), else from an im2col tile.
template <typename T, int NT, bool DIRECT>
__global__ void __launch_bounds__(THREADS)
conv_stem_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, void* __restrict__ out, Geometry g) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int KSTEP = BF16 ? 16 : 8;       // the mma depth
  constexpr int V = 16 / sizeof(T);          // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);                      // (Kp or K, ws)
  T* a_tile = reinterpret_cast<T*>(smem + g.a_off);         // (128, as), im2col path
  int* koff_tab = reinterpret_cast<int*>(smem + g.koff_off);  // (Kp,), im2col path

  const int C = g.C, F = g.F, s = g.s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int f0 = blockIdx.y * g.chunk;
  const int krows = DIRECT ? g.K : g.Kp;

  // the chunk's weights, once per block, columns in channel_of_column's
  // order, zero past F and (im2col path) past K
  for (int e = threadIdx.x; e < krows * g.chunk; e += THREADS) {
    const int k = e / g.chunk, j = e - k * g.chunk;
    const int f = f0 + channel_of_column(j, NT);
    w_s[k * g.ws + j] = k < g.K && f < F ? w[(int64_t)k * F + f] : zero<T>();
  }
  if (!DIRECT) {
    // im2col: the tile offset of (pixel, k) is base(pixel) + koff[k], k = (ky, kx, c)
    for (int k = threadIdx.x; k < g.Kp; k += THREADS) {
      const int tap = k / C, ky = tap / g.kw;
      koff_tab[k] = k < g.K ? (ky * g.cols_in + tap - ky * g.kw) * C + k - tap * C : -1;
    }
  }

  // stage output tile t's input tile and halo into buffer buf, zero outside the image
  auto stage = [&](int t, int buf) {
    T* tile = reinterpret_cast<T*>(smem + g.tile_off + buf * g.tile_bytes);
    const int tx = t % g.ntx, ty = (t / g.ntx) % g.nty, b = t / (g.ntx * g.nty);
    const int iy0 = ty * TH * s - g.pt, ix0 = tx * TW * s - g.pl;
    const T* xb = x + (int64_t)b * g.H * g.W * C;
    if (DIRECT) {                             // 16-byte cp.async, by stride phase, a row per warp
      const int nv = C / V;
      for (int row = warp; row < g.rows_in; row += TH) {
        const int iy = iy0 + row;
        const bool in_row = iy >= 0 && iy < g.H;
        for (int j = lane; j < g.cols_in * nv; j += 32) {
          const int col = j / nv, c = (j - col * nv) * V;
          const int ix = ix0 + col;
          const bool valid = in_row && ix >= 0 && ix < g.W;
          T* dst = tile + (row * g.pitch + col_slot(col, s, g.colsp)) * g.cs + c;
          cp_async16(dst, valid ? xb + ((int64_t)iy * g.W + ix) * C + c : x, valid);
        }
      }
      cp_async_commit();
    } else {                                  // element by element, a tile row per warp
      const int span = g.cols_in * C;         // a tile row: contiguous in x
      const int jlo = max(0, -ix0) * C, jhi = min(g.cols_in, g.W - ix0) * C;
      for (int row = warp; row < g.rows_in; row += TH) {
        const int iy = iy0 + row;
        const bool in_row = iy >= 0 && iy < g.H;
        const T* src = xb + ((int64_t)iy * g.W + ix0) * C;
        for (int j = lane; j < span; j += 32)
          tile[row * span + j] = in_row && j >= jlo && j < jhi ? src[j] : zero<T>();
      }
    }
  };

  const uint32_t w_base = smem_addr(w_s);
  const int px = lane & 15;                   // this lane's A row (ldmatrix address)
  const int koff = (lane >> 4) * V;           // and its half of the k-step
  int buf = 0;
  if (blockIdx.x < g.n_tiles) stage(blockIdx.x, 0);
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const int next = t + gridDim.x;
    cp_async_wait_all();
    __syncthreads();                          // tile t (and the weights) staged; the
                                              // other buffer's readers are done
    if (g.n_buf == 2 && next < g.n_tiles) stage(next, buf ^ 1);   // lands during tile t
    const T* tile = reinterpret_cast<const T*>(smem + g.tile_off + buf * g.tile_bytes);
    const int tx = t % g.ntx, ty = (t / g.ntx) % g.nty, b = t / (g.ntx * g.nty);

    if (!DIRECT) {
      // im2col: row = output pixel of the tile, column k tap-major
      for (int e = threadIdx.x; e < TH * TW * g.Kp; e += THREADS) {
        const int k = e / (TH * TW), pix = e % (TH * TW);
        const int off = koff_tab[k];
        const int base = ((pix / TW) * s * g.cols_in + (pix % TW) * s) * C;
        a_tile[pix * g.as + k] = off >= 0 ? tile[base + off] : zero<T>();
      }
      __syncthreads();
    }

    // bf16 sums in the mma accumulator itself (total); f32 joins its
    // 3xTF32 accumulators (acc, sml) into total after every tap
    float total[NT][4], acc[NT][4], sml[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) total[n][i] = acc[n][i] = sml[n][i] = 0.f;

    // one k-step: A at a_addr (this lane's row address), B rows k..k+KSTEP
    auto step = [&](uint32_t a_addr, int k) {
      uint32_t a[4];
      ldsm_x4(a, a_addr);
      if constexpr (BF16) {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t bq[4];
          ldsm_x4_trans(bq, w_base + ((k + (lane & 15)) * g.ws + p * 16 + (lane >> 4) * 8) * 2);
          mma_bf16_16816(total[2 * p], a, bq[0], bq[1]);
          mma_bf16_16816(total[2 * p + 1], a, bq[2], bq[3]);
        }
      } else {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
        const float* wf = reinterpret_cast<const float*>(w_s);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(wf[(k + tq) * g.ws + n * 8 + gq], bh0, bl0);
          split_tf32(wf[(k + tq + 4) * g.ws + n * 8 + gq], bh1, bl1);
          mma_tf32_1688(sml[n], al, bh0, bh1);
          mma_tf32_1688(sml[n], ah, bl0, bl1);
          mma_tf32_1688(acc[n], ah, bh0, bh1);
        }
      }
    };
    auto join = [&]() {
      if constexpr (!BF16) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            total[n][i] += acc[n][i] + sml[n][i];
            acc[n][i] = sml[n][i] = 0.f;
          }
      }
    };

    if (DIRECT) {
      const uint32_t tile_base = smem_addr(tile);
      for (int ky = 0; ky < g.kh; ++ky) {
        for (int kx = 0; kx < g.kw; ++kx) {
          const int pix = (warp * s + ky) * g.pitch + col_slot(kx, s, g.colsp) + px;
          const uint32_t a_addr = tile_base + (pix * g.cs + koff) * (int)sizeof(T);
          const int k0 = (ky * g.kw + kx) * C;
          for (int c0 = 0; c0 < C; c0 += KSTEP) step(a_addr + c0 * (int)sizeof(T), k0 + c0);
          join();
        }
      }
    } else {
      const uint32_t a_addr =
          smem_addr(a_tile) + ((warp * TW + px) * g.as + koff) * (int)sizeof(T);
      const int steps = g.Kp / KSTEP;
      for (int ks = 0; ks < steps; ++ks) {
        step(a_addr + ks * KSTEP * (int)sizeof(T), ks * KSTEP);
        if (ks % FLUSH_STEPS == FLUSH_STEPS - 1) join();
      }
      join();
    }

    // epilogue on the fragments: + bias, the activation, one rounding; each
    // thread's channels of a pixel are consecutive (channel_of_column)
    const int oy = ty * TH + warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ox = tx * TW + gq + 8 * h;
      if (oy >= g.Ho || ox >= g.Wo) continue;           // the ragged last tiles
      const int64_t pix_off = (((int64_t)b * g.Ho + oy) * g.Wo + ox) * F;
#pragma unroll
      for (int q = 0; q < (NT + 3) / 4; ++q) {
        constexpr int kMaxW = 4;
        const int wq = NT - 4 * q < kMaxW ? NT - 4 * q : kMaxW;
        const int f = f0 + 32 * q + 2 * wq * tq;         // this thread's first channel
        float v[2 * kMaxW] = {};
#pragma unroll
        for (int r = 0; r < kMaxW; ++r) {
          if (r >= wq) break;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int fc = f + 2 * r + c;
            const float bv = bias && fc < F ? bias[fc] : 0.f;
            v[2 * r + c] = activate(g.act, __fadd_rn(total[4 * q + r][2 * h + c], bv));
          }
        }
        if (g.vec_out && f + 2 * wq <= F) {
          if (g.out_bf16) {
            uint32_t pk[kMaxW];
#pragma unroll
            for (int r = 0; r < kMaxW; ++r) {
              __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * r], v[2 * r + 1]);
              pk[r] = *reinterpret_cast<uint32_t*>(&h2);
            }
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + pix_off + f;
            if (wq == 4) *reinterpret_cast<uint4*>(dst) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
            else *reinterpret_cast<uint2*>(dst) = make_uint2(pk[0], pk[1]);
          } else {
            float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + pix_off + f);
            dst[0] = make_float4(v[0], v[1], v[2], v[3]);
            if (wq == 4) dst[1] = make_float4(v[4], v[5], v[6], v[7]);
          }
        } else {
          for (int i = 0; i < 2 * wq && f + i < F; ++i) {
            if (g.out_bf16) static_cast<__nv_bfloat16*>(out)[pix_off + f + i] = __float2bfloat16_rn(v[i]);
            else static_cast<float*>(out)[pix_off + f + i] = v[i];
          }
        }
      }
    }

    if (g.n_buf == 1) {
      __syncthreads();                        // the one buffer's readers are done
      if (next < g.n_tiles) stage(next, 0);
    }
    buf ^= g.n_buf - 1;
  }
}

template <typename T, int NT, bool DIRECT>
int launch(const void* x, const void* w, const float* bias, void* out, const Geometry& g,
           size_t smem, cudaStream_t stream) {
  auto kernel = conv_stem_mma_kernel<T, NT, DIRECT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a second tile buffer only where it costs no resident block
  Geometry gl = g;
  int per_sm = 0, per_sm1 = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  if (g.n_buf == 2) {
    const size_t smem1 = smem - g.tile_bytes;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm1, kernel, THREADS,
                                                             smem1)) != cudaSuccess)
      return (int)err;
    if (per_sm1 > per_sm) {
      gl.n_buf = 1;
      gl.a_off -= g.tile_bytes;
      gl.koff_off -= g.tile_bytes;
      smem = smem1;
      per_sm = per_sm1;
    }
  }
  if (per_sm < 1) return -7;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  // the direct path's blocks are persistent, as many as are resident at once
  // (shared by the chunks); the im2col path's stage their tiles with plain
  // loads, which only other blocks overlap: a block per tile
  const int resident = DIRECT ? (per_sm * sms + g.n_chunks - 1) / g.n_chunks : g.n_tiles;
  const dim3 grid(g.n_tiles < resident ? g.n_tiles : resident, g.n_chunks);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                          bias, out, gl);
  return (int)cudaGetLastError();
}

template <typename T, bool DIRECT>
int by_chunk(const void* x, const void* w, const float* bias, void* out, const Geometry& g,
             size_t smem, cudaStream_t st) {
  switch (g.chunk / 8) {
    case 2: return launch<T, 2, DIRECT>(x, w, bias, out, g, smem, st);
    case 4: return launch<T, 4, DIRECT>(x, w, bias, out, g, smem, st);
    case 6: return launch<T, 6, DIRECT>(x, w, bias, out, g, smem, st);
    case 8: return launch<T, 8, DIRECT>(x, w, bias, out, g, smem, st);
  }
  return -5;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
size_t round16(size_t n) { return (n + 15) / 16 * 16; }

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take, or the cudaError_t of the launch (cudaGetLastError) otherwise.
//   in_dtype, out_dtype: 0 = float32, 1 = bfloat16 (w is in_dtype)
//   bias:   (F,) float32, or null
//   act:    0 none, 1 relu, 2 mish, 3 leaky (slope 0.1)
// The A path, the channel chunk, the vector widths and the shared-memory
// layout follow from the shapes and the pointers' alignment.
int poet_conv_stem_fwd(const void* x, const void* w, const void* bias, void* out, int in_dtype,
                       int out_dtype, int B, int H, int W, int C, int F, int kh, int kw,
                       int stride, int pt, int pl, int Ho, int Wo, int act, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || kh < 1 || kw < 1) return -1;
  if (stride < 1 || pt < 0 || pl < 0 || Ho < 1 || Wo < 1) return -2;
  if (act < ACT_NONE || act > ACT_LEAKY) return -6;
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) return -5;
  const size_t elem = in_dtype == 0 ? 4 : 2;
  const int kstep = in_dtype == 0 ? 8 : 16;
  const int v = 16 / (int)elem;
  const bool direct = C % kstep == 0 && aligned16(x);
  Geometry g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.F = F; g.kh = kh; g.kw = kw; g.s = stride;
  g.pt = pt; g.pl = pl; g.Ho = Ho; g.Wo = Wo; g.act = act;
  const int f16 = (F + 15) / 16 * 16;
  g.chunk = f16 < MAX_CHUNK ? f16 : MAX_CHUNK;
  g.n_chunks = (F + g.chunk - 1) / g.chunk;
  if (g.n_chunks > 65535) return -4;
  g.nty = (Ho + TH - 1) / TH;
  g.ntx = (Wo + TW - 1) / TW;
  if ((int64_t)B * g.nty * g.ntx > 0x7fffffff) return -4;
  g.n_tiles = B * g.nty * g.ntx;
  g.rows_in = (TH - 1) * stride + kh;
  g.cols_in = (TW - 1) * stride + kw;
  g.colsp = (g.cols_in + stride - 1) / stride;
  g.pitch = direct ? stride * g.colsp : g.cols_in;
  g.cs = direct ? C + v : C;
  g.K = kh * kw * C;
  g.Kp = (g.K + kstep - 1) / kstep * kstep;
  g.as = g.Kp + v;
  g.ws = g.chunk + W_PAD;
  const size_t w_bytes = round16((size_t)(direct ? g.K : g.Kp) * g.ws * elem);
  const size_t tile_bytes = round16((size_t)g.rows_in * g.pitch * g.cs * elem);
  const size_t a_bytes = direct ? 0 : (size_t)TH * TW * g.as * elem + (size_t)g.Kp * 4;
  // two tile buffers where they fit (the next tile lands during this one)
  g.n_buf = w_bytes + 2 * tile_bytes + a_bytes <= MAX_SMEM ? 2 : 1;
  const size_t smem = w_bytes + g.n_buf * tile_bytes + a_bytes;
  if (smem > MAX_SMEM) return -7;   // the tile and the weights do not fit
  g.tile_bytes = (int)tile_bytes;
  g.tile_off = (int)w_bytes;
  g.a_off = (int)(w_bytes + g.n_buf * tile_bytes);
  g.koff_off = (int)(g.a_off + (size_t)TH * TW * g.as * elem);
  g.out_bf16 = out_dtype == 1;
  g.vec_out = F % 8 == 0 && aligned16(out);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1) {
    return direct ? by_chunk<__nv_bfloat16, true>(x, w, bf, out, g, smem, st)
                  : by_chunk<__nv_bfloat16, false>(x, w, bf, out, g, smem, st);
  }
  return direct ? by_chunk<float, true>(x, w, bf, out, g, smem, st)
                : by_chunk<float, false>(x, w, bf, out, g, smem, st);
}

const char* poet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
