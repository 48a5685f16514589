// Fused two-layer feed-forward, forward pass: out = relu(x @ W1 + b1) @ W2 + b2.
//
// Replaces the TPU kernel fourierflow_tpu/ops/pallas_ff.py::_ff_kernel
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
