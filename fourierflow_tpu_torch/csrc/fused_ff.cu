// Fused two-layer feed-forward: out = relu(x @ W1 + b1) @ W2 + b2, forward
// (ff_fwd) and backward (ff_bwd, described after the forward kernel).
//
// Forward. Replaces the TPU kernel fourierflow_tpu/ops/pallas_ff.py::_ff_kernel
// (launched by _ff_pallas). The TPU version keeps a [1024, 4C] hidden tile
// in VMEM; a Hopper block has at most 227 KB of shared memory, so here one
// block takes a 64-row tile of x and walks the hidden dimension in chunks
// of 64: h_c = relu(x_tile @ W1[:, c] + b1[c]) goes to shared memory and is
// folded at once into acc += h_c @ W2[c, :], kept in registers. The hidden
// layer never reaches device memory, so the kernel moves x in and out out,
// plus the weights once per block (from L2).
//
// Bound at the flagship shapes (rows 77,824, C 64, hidden 256): 5.10 GFLOP
// against 39.8 MB (f32). In f32 on CUDA cores that is operations-bound
// (67 TFLOP/s); the bf16 bound is memory. This first version is a plain
// shared-memory tiling on CUDA cores with f32 accumulation; tensor cores
// (wgmma) are later work.
//
// Types: x, weights, biases and out share one type (float or bf16);
// arithmetic is f32 throughout (the hidden chunk stays f32). Ragged rows are
// masked in the kernel. W1 [C_in, H] and W2 [H, C_out] are read through
// element strides, so the transposed views of torch's [out, in] weights go
// in without a copy; the staging loops walk the input dimension fastest,
// which reads that layout coalesced. x, biases and out are contiguous.
// C_out <= 64. Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // rows of x per block
constexpr int HC = 64;           // hidden columns per chunk
constexpr int TX = 16;           // threads along columns
constexpr int TY = 16;           // threads along rows
constexpr int NT = TX * TY;      // 256 threads
constexpr int RT = BM / TY;      // rows per thread (4)
constexpr int HQ = HC / TX;      // hidden columns per thread (4)
constexpr int CQ = 4;            // output columns per thread: C_out <= CQ * TX = 64

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory (floats): xs [BM][cin+1] | w1s [cin][HC+1] | hs [BM][HC+1] | w2s [HC][cout+1].
// The +1 row pads keep the rows a warp touches at once in different banks.
__host__ __device__ __forceinline__ size_t smem_floats(int cin, int cout) {
  return (size_t)BM * (cin + 1) + (size_t)cin * (HC + 1) + (size_t)BM * (HC + 1) +
         (size_t)HC * (cout + 1);
}

template <typename T>
__global__ void __launch_bounds__(NT) ff_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
    int rows, int cin, int hidden, int cout, int w1_sc, int w1_sh, int w2_sh, int w2_so) {
  extern __shared__ float smem[];
  const int xld = cin + 1;
  const int hld = HC + 1;
  const int w1ld = HC + 1;
  const int w2ld = cout + 1;
  float* xs = smem;
  float* w1s = xs + BM * xld;
  float* hs = w1s + cin * w1ld;
  float* w2s = hs + BM * hld;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t row0 = (int64_t)blockIdx.x * BM;

  for (int i = tid; i < BM * cin; i += NT) {
    const int r = i / cin;
    const int c = i - r * cin;
    const int64_t gr = row0 + r;
    xs[r * xld + c] = gr < rows ? to_f(x[gr * cin + c]) : 0.f;
  }

  float acc[RT][CQ];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < CQ; ++q) acc[r][q] = 0.f;

  for (int h0 = 0; h0 < hidden; h0 += HC) {
    __syncthreads();  // xs written (first chunk); hs/w2s of the last chunk consumed
    // Element i of a chunk is (j, c) = (i / cin, i % cin) for W1 and
    // (o, j) = (i / HC, i % HC) for W2; both are stepped without a division.
    for (int i = tid, j = tid / cin, c = tid % cin; i < cin * HC; i += NT) {
      const int gh = h0 + j;
      w1s[c * w1ld + j] = gh < hidden ? to_f(w1[c * w1_sc + gh * w1_sh]) : 0.f;
      c += NT % cin;
      j += NT / cin + (c >= cin);
      if (c >= cin) c -= cin;
    }
#pragma unroll 4
    for (int i = tid; i < HC * cout; i += NT) {
      const int o = i / HC;
      const int j = i % HC;
      const int gh = h0 + j;
      w2s[j * w2ld + o] = gh < hidden ? to_f(w2[gh * w2_sh + o * w2_so]) : 0.f;
    }
    __syncthreads();

    float h[RT][HQ];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < HQ; ++q) h[r][q] = 0.f;
    for (int c = 0; c < cin; ++c) {
      float wv[HQ];
#pragma unroll
      for (int q = 0; q < HQ; ++q) wv[q] = w1s[c * w1ld + tx + TX * q];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float xv = xs[(ty * RT + r) * xld + c];
#pragma unroll
        for (int q = 0; q < HQ; ++q) h[r][q] = fmaf(xv, wv[q], h[r][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < HQ; ++q) {
      const int j = tx + TX * q;
      const int gh = h0 + j;
      const float bb = gh < hidden ? to_f(b1[gh]) : 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) hs[(ty * RT + r) * hld + j] = fmaxf(h[r][q] + bb, 0.f);
    }
    __syncthreads();

    for (int j = 0; j < HC; ++j) {
      float wv[CQ];
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int o = tx + TX * q;
        wv[q] = o < cout ? w2s[j * w2ld + o] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float hv = hs[(ty * RT + r) * hld + j];
#pragma unroll
        for (int q = 0; q < CQ; ++q) acc[r][q] = fmaf(hv, wv[q], acc[r][q]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int64_t gr = row0 + ty * RT + r;
    if (gr >= rows) continue;
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int o = tx + TX * q;
      if (o < cout) out[gr * cout + o] = from_f<T>(acc[r][q] + to_f(b2[o]));
    }
  }
}

// Backward. Replaces the TPU kernel fourierflow_tpu/ops/pallas_ff.py::
// _make_bwd_kernel (launched by _ff_bwd_pallas). Given x [rows, C_in] and the
// output gradient g [rows, C_out], per row it recomputes pre = x @ W1 + b1 and
// h = relu(pre), forms dh = (g @ W2^T) * [pre > 0], writes dx = dh @ W1^T and
// accumulates dW1 = x^T dh, db1 = sum dh, dW2 = h^T g, db2 = sum g in f32.
// Neither pre, h nor dh reaches device memory.
//
// The TPU kernel keeps the four weight-gradient sums in one output block
// across a grid that runs in order. Hopper blocks run in no order, and the
// sums (C_in*H + H*C_out floats, 128 KB in f32 at the flagship) fit neither
// in registers nor twice in one SM's shared memory. So the grid is
// persistent: one block per SM (the wrapper passes `blocks` = min(tiles,
// SMs)), each looping over 64-row tiles blockIdx.x, blockIdx.x + blocks, ...
// (that loop takes the place of the TPU's sequential grid) and holding its
// weight-gradient sums in shared memory, each sum owned by one thread, so no
// atomics are needed. A block walks the hidden dimension in chunks of 64 for
// every tile, like the forward; dx of the tile stays in registers across the
// chunks. At the end each block writes its sums to an f32 partial row, and a
// second small kernel adds the rows in block order. The gradients are thus
// bit-identical from run to run on a given card. We chose "a block loops
// over row tiles" over "a block owns a slice of the hidden dimension"
// because dx sums over the whole hidden dimension: with the hidden dimension
// split across blocks, dx would need a second pass over a [rows, C_in] f32
// partial per slice, which is more traffic than x, g and dx together.
//
// Bound at the flagship (rows 77,824, C 64, H 256): 10*rows*C*H = 12.75 GFLOP
// and 59.8 MB in f32 (x and g in, dx out), so 0.190 ms in f32 on CUDA cores
// (operations); in bf16 0.0129 ms of operations against 0.0089 ms of bytes.
// This first version computes five 64x64x64 products per tile and chunk on
// CUDA cores in f32 (4x4 outputs per thread), like the forward; tensor cores
// are later work. Shared memory: six padded 64x64 f32 tiles (x, g, W1 and W2
// chunks, h, dh) and the sums, 232,192 bytes at the flagship, so C_in <= 64,
// C_out <= 64 and H <= 256 at C = 64 (the wrapper checks the size). Rows
// beyond `rows` are staged as zeros, so g = 0 there and they add nothing.
constexpr int TD = 64;           // tile edge: rows per tile, hidden chunk, C_in and C_out bound
constexpr int LD = TD + 1;       // padded row length of the staged tiles
constexpr int NQ = TD / TX;      // output columns per thread (4)

__host__ __device__ __forceinline__ size_t bwd_sum_floats(int cin, int hidden, int cout) {
  return (size_t)cin * hidden + hidden + (size_t)hidden * cout + cout;
}
__host__ __device__ __forceinline__ size_t bwd_smem_floats(int cin, int hidden, int cout) {
  return 6 * (size_t)TD * LD + bwd_sum_floats(cin, hidden, cout);
}

// acc[r][q] += sum_k A(m, k) B(k, n) over k < 64, for the thread's outputs
// m = ty*RT + r, n = tx + TX*q, with A(m, k) = a[m*AM + k*AK] and
// B(k, n) = b[k*BK + n*BN] in shared memory. A warp reads two distinct A
// values (broadcast) and 16 B values on distinct banks (the +1 row pad).
template <int AM, int AK, int BK, int BN>
__device__ __forceinline__ void tile_mm(const float* __restrict__ a, const float* __restrict__ b,
                                        float (&acc)[RT][NQ]) {
  a += (threadIdx.x / TX) * RT * AM;
  b += (threadIdx.x % TX) * BN;
#pragma unroll 4
  for (int k = 0; k < TD; ++k) {
    float bv[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) bv[q] = b[k * BK + q * TX * BN];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float av = a[r * AM + k * AK];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[r][q] = fmaf(av, bv[q], acc[r][q]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) ff_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2, T* __restrict__ dx,
    float* __restrict__ partial, int rows, int cin, int hidden, int cout, int w1_sc, int w1_sh,
    int w2_sh, int w2_so) {
  extern __shared__ float smem[];
  float* xs = smem;           // [row][c]
  float* gs = xs + TD * LD;   // [row][o]
  float* w1s = gs + TD * LD;  // [c][j]: W1[c, h0 + j]
  float* w2s = w1s + TD * LD; // [j][o]: W2[h0 + j, o]
  float* hs = w2s + TD * LD;  // [row][j]
  float* dhs = hs + TD * LD;  // [row][j]
  float* sums = dhs + TD * LD;
  float* s_w1 = sums;                           // [cin][hidden]
  float* s_b1 = s_w1 + (size_t)cin * hidden;    // [hidden]
  float* s_w2 = s_b1 + hidden;                  // [hidden][cout]
  float* s_b2 = s_w2 + (size_t)hidden * cout;   // [cout]
  const int n_sums = (int)bwd_sum_floats(cin, hidden, cout);

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int i = tid; i < n_sums; i += NT) sums[i] = 0.f;

  const int n_tiles = (rows + TD - 1) / TD;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * TD;
    __syncthreads();  // the sums are zeroed; the last tile's tiles are consumed
    // Element i of a 64x64 tile is (i / 64, i % 64); out-of-range entries are zeros.
    for (int i = tid; i < TD * TD; i += NT) {
      const int r = i / TD;
      const int c = i % TD;
      const int64_t gr = row0 + r;
      xs[r * LD + c] = gr < rows && c < cin ? to_f(x[gr * cin + c]) : 0.f;
      gs[r * LD + c] = gr < rows && c < cout ? to_f(g[gr * cout + c]) : 0.f;
    }
    __syncthreads();
    if (tid < cout) {
      float s = 0.f;
      for (int r = 0; r < TD; ++r) s += gs[r * LD + tid];
      s_b2[tid] += s;
    }

    float dxa[RT][NQ];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < NQ; ++q) dxa[r][q] = 0.f;

    for (int h0 = 0; h0 < hidden; h0 += TD) {
      __syncthreads();  // the last chunk's W1, W2, h and dh tiles are consumed
      // W1 is staged with c fastest and W2 with j fastest: the order of the
      // model's weight.t() views in memory.
      for (int i = tid; i < TD * TD; i += NT) {
        const int a = i % TD;
        const int b = i / TD;
        const int gh_b = h0 + b;
        const int gh_a = h0 + a;
        w1s[a * LD + b] = a < cin && gh_b < hidden ? to_f(w1[a * w1_sc + gh_b * w1_sh]) : 0.f;
        w2s[a * LD + b] = gh_a < hidden && b < cout ? to_f(w2[gh_a * w2_sh + b * w2_so]) : 0.f;
      }
      __syncthreads();

      float pre[RT][NQ], gp[RT][NQ];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) pre[r][q] = gp[r][q] = 0.f;
      tile_mm<LD, 1, LD, 1>(xs, w1s, pre);  // x @ W1
      tile_mm<LD, 1, 1, LD>(gs, w2s, gp);   // g @ W2^T
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = tx + TX * q;
        const float bb = h0 + j < hidden ? to_f(b1[h0 + j]) : 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float p = pre[r][q] + bb;
          hs[(ty * RT + r) * LD + j] = fmaxf(p, 0.f);
          dhs[(ty * RT + r) * LD + j] = p > 0.f ? gp[r][q] : 0.f;
        }
      }
      __syncthreads();

      tile_mm<LD, 1, 1, LD>(dhs, w1s, dxa);  // dx += dh @ W1^T
      float t[RT][NQ];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < NQ; ++q) t[r][q] = 0.f;
      tile_mm<1, LD, LD, 1>(xs, dhs, t);  // x^T dh: rows (c), columns (j)
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int c = ty * RT + r;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int gh = h0 + tx + TX * q;
          if (c < cin && gh < hidden) s_w1[c * hidden + gh] += t[r][q];
          t[r][q] = 0.f;
        }
      }
      tile_mm<1, LD, LD, 1>(hs, gs, t);  // h^T g: rows (j), columns (o)
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int gh = h0 + ty * RT + r;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int o = tx + TX * q;
          if (gh < hidden && o < cout) s_w2[gh * cout + o] += t[r][q];
        }
      }
      if (tid < TD && h0 + tid < hidden) {
        float s = 0.f;
        for (int r = 0; r < TD; ++r) s += dhs[r * LD + tid];
        s_b1[h0 + tid] += s;
      }
    }

#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int64_t gr = row0 + ty * RT + r;
      if (gr >= rows) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = tx + TX * q;
        if (c < cin) dx[gr * cin + c] = from_f<T>(dxa[r][q]);
      }
    }
  }
  __syncthreads();
  float* dst = partial + (int64_t)blockIdx.x * n_sums;
  for (int i = tid; i < n_sums; i += NT) dst[i] = sums[i];
}

// out[i] = sum over blocks b = 0, 1, ... of partial[b][i], in that order.
__global__ void ff_bwd_reduce_kernel(const float* __restrict__ partial, int blocks, int n,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(int64_t)b * n + i];
  out[i] = s;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* w1, const void* b1,
                       const void* w2, void* dx, float* partial, float* out, int rows, int cin,
                       int hidden, int cout, int w1_sc, int w1_sh, int w2_sh, int w2_so,
                       int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats(cin, hidden, cout);
  cudaError_t err = cudaFuncSetAttribute(ff_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ff_bwd_kernel<T><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx), partial, rows,
      cin, hidden, cout, w1_sc, w1_sh, w2_sh, w2_so);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (int)bwd_sum_floats(cin, hidden, cout);
  ff_bwd_reduce_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(partial, blocks, n, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int rows, int cin, int hidden, int cout,
                   int w1_sc, int w1_sh, int w2_sh, int w2_so,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(cin, cout);
  cudaError_t err = cudaFuncSetAttribute(ff_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((rows + BM - 1) / BM));
  ff_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), rows, cin,
      hidden, cout, w1_sc, w1_sh, w2_sh, w2_so);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16. w1 (c, h) is at w1[c * w1_sc + h * w1_sh],
// w2 (h, o) at w2[h * w2_sh + o * w2_so]; every weight offset fits an int.
// Returns a cudaError_t (0 on success).
extern "C" int ff_fwd(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, int rows, int cin, int hidden, int cout,
                      int w1_sc, int w1_sh, int w2_sh, int w2_so,
                      void* stream) {
  if (rows <= 0 || cin <= 0 || hidden <= 0 || cout <= 0 || cout > CQ * TX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w1, b1, w2, b2, out, rows, cin, hidden, cout, w1_sc, w1_sh,
                              w2_sh, w2_so, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, rows, cin, hidden, cout, w1_sc,
                                      w1_sh, w2_sh, w2_so, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory bytes one block needs, for the wrapper's checks.
extern "C" long long ff_fwd_smem_bytes(int cin, int cout) {
  return (long long)(sizeof(float) * smem_floats(cin, cout));
}

// Backward: dx (x's type, [rows, cin]) and, in `out` (f32), dW1 [cin, hidden],
// db1 [hidden], dW2 [hidden, cout], db2 [cout] one after the other. `partial`
// is f32 scratch of blocks * (cin*hidden + hidden + hidden*cout + cout) floats; `blocks` is the
// grid of the main kernel, at most the number of 64-row tiles. Weights as in
// ff_fwd. Returns a cudaError_t (0 on success).
extern "C" int ff_bwd(int dtype, const void* x, const void* g, const void* w1, const void* b1,
                      const void* w2, void* dx, void* partial, void* out, int rows, int cin,
                      int hidden, int cout, int w1_sc, int w1_sh, int w2_sh, int w2_so,
                      int blocks, void* stream) {
  if (rows <= 0 || cin <= 0 || cin > TD || hidden <= 0 || cout <= 0 || cout > TD ||
      blocks <= 0 || blocks > (rows + TD - 1) / TD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, g, w1, b1, w2, dx, p, o, rows, cin, hidden, cout, w1_sc,
                                  w1_sh, w2_sh, w2_so, blocks, s);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, g, w1, b1, w2, dx, p, o, rows, cin, hidden, cout,
                                          w1_sc, w1_sh, w2_sh, w2_so, blocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" long long ff_bwd_smem_bytes(int cin, int hidden, int cout) {
  return (long long)(sizeof(float) * bwd_smem_floats(cin, hidden, cout));
}
