// One branch of the F-FNO spectral mix along one grid axis, forward pass:
//   out (+)= irdft_axis( W . rdft_axis(x) )
// with the truncated orthonormal real DFT, M modes and per-mode complex
// C x C channel mixing W = Wr + i Wi.
//
// Replaces the TPU kernel fourierflow_tpu/ops/pallas_spectral.py::
// _make_mix_kernel (+ _branch), launched by _mix_pallas. The TPU kernel keeps
// one batch element's whole [X, Y, C] block (1 MB in f32) resident in VMEM and
// runs both branches on it; neither that block nor the 512 KB of f32 mode
// weights per branch fits in a Hopper block's 227 KB of shared memory. Here
// the kernel transforms along an axis given by strides, and the wrapper
// launches it twice on one stream: the first launch (Y branch) writes, the
// second (X branch) adds to what the first wrote. Stream order makes the sum
// deterministic with no atomics. Each axis has its own n and basis, so
// non-square grids need no extra work.
//
// Per block: L = 4 lines [L, n, C] of one axis are staged in shared memory
// with the forward basis [n, 2M] and the inverse basis [2M, n]; the block
// forms the spectra [L, C, 2M], mixes them mode by mode against Wr[m], Wi[m]
// read from device memory (L2-resident: 1 MB for both branches in f32),
//   yr = sr @ Wr - si @ Wi,  yi = sr @ Wi + si @ Wr,
// applies the inverse basis and writes or accumulates the lines. The mode
// weights are read in the parameter's own [Ci, Co, M, 2] layout through its
// strides; the mixing step gives consecutive threads consecutive modes, which
// reads a contiguous parameter coalesced.
//
// Bound at the flagship shapes (x [19, 64, 64, 64], M 16): 2.55 GFLOP for
// both branches against 39.8 MB (f32) moved, so memory-bound in bf16 and
// close to balanced in f32. Known weakness of this first version: every
// block rereads the whole weight set from L2 (2 M C^2 values per branch).
//
// The adjoint (the gradient with respect to x; the TPU package's
// _fused_mix_bwd launches its kernel a second time in the same way) is this
// kernel on the adjoint operator: the forward basis becomes the inverse
// basis transposed and the inverse basis the forward one transposed (the
// wrapper passes cached contiguous transposes; they carry irdft's Hermitian
// weights, so the adjoint is no forward rDFT), the weights are read
// (i, o)-transposed by swapping the w_si and w_so strides, and `conj`
// negates the imaginary weight in the mixing loop. Its bound is the
// forward's.
//
// Types: x is float or bf16; the mode weights are float or x's type, and are
// rounded to x's type when they are wider (as the plain version casts them).
// All arithmetic is f32. For bf16 x the kernel rounds where the JAX kernel's
// _branch does: the bases as they are staged, the spectra s as they are
// stored, and the mixed spectra y as they are stored (round_as, a no-op for
// f32 x); the inverse product stays f32. The first branch may write an f32
// scratch (used for bf16 output so the sum of the two branches is rounded
// once); `prev`, when given, is an f32 array added before the store. Plain C
// interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 4;      // lines per block
constexpr int KC = 16;    // spectrum rows (forward) / samples (inverse) per register chunk
constexpr int NT = 256;   // threads per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to x's type TI, in f32.
template <typename TI>
__device__ __forceinline__ float round_as(float v) { return to_f(from_f<TI>(v)); }
// A mode weight of type TW as x's type TI would hold it, in f32.
template <typename TI, typename TW>
__device__ __forceinline__ float weight_f(TW v) { return round_as<TI>(to_f(v)); }

// Real and imaginary part of one mode weight; `pair` when they are adjacent
// and aligned, so that one load fetches both.
template <typename TI>
__device__ __forceinline__ void load_weight(const float* p, int64_t sp, bool pair, float& a,
                                            float& b) {
  if (pair) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = weight_f<TI>(v.x), b = weight_f<TI>(v.y);
  } else {
    a = weight_f<TI>(p[0]), b = weight_f<TI>(p[sp]);
  }
}
template <typename TI>
__device__ __forceinline__ void load_weight(const __nv_bfloat16* p, int64_t sp, bool pair,
                                            float& a, float& b) {
  if (pair) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(v), b = __high2float(v);
  } else {
    a = to_f(p[0]), b = to_f(p[sp]);
  }
}

__host__ __device__ __forceinline__ int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared memory layout in floats; et and cb are multiples of 16 floats long
// so the float4 reads of both bases are aligned:
//   et [n][KP]     forward basis, columns 0..M-1 real, M..2M-1 imaginary, zero-padded to KP
//   cb [2M][NP]    inverse basis, zero-padded to NP samples
//   s  [L][C][2M+1] spectra (the odd row length keeps a warp's rows in different banks)
//   xs [L][n][C]   input lines; reused for the mixed spectra y [L][C][2M+1]
__host__ __device__ __forceinline__ size_t smem_floats(int n, int modes, int c) {
  const int k = 2 * modes;
  const int kp = round_up(k, KC);
  const int np = round_up(n, KC);
  const int r = n > k + 1 ? n : k + 1;
  return (size_t)n * kp + (size_t)k * np + (size_t)L * c * (k + 1) + (size_t)L * r * c;
}

template <typename TI, typename TW, typename TO>
__global__ void __launch_bounds__(NT) spectral_axis_kernel(
    const TI* __restrict__ x, const float* __restrict__ fwd, const float* __restrict__ inv,
    const TW* __restrict__ w, int64_t w_si, int64_t w_so, int64_t w_sm, int64_t w_sp, bool pair,
    float wi_sign, const float* prev, TO* out, int n_lines, int lines_per_batch, int64_t batch_stride,
    int64_t line_stride, int64_t elem_stride, int n, int modes, int C) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int K = 2 * modes;
  const int KS = K + 1;
  const int KP = round_up(K, KC);
  const int NP = round_up(n, KC);
  float* et = smem;
  float* cb = et + n * KP;
  float* s = cb + K * NP;
  float* xs = s + L * C * KS;
  float* y = xs;

  const int tid = threadIdx.x;
  const int line0 = blockIdx.x * L;

  for (int i = tid; i < n * KP; i += NT) {
    const int t = i / KP;
    const int k = i - t * KP;
    et[i] = k < K ? round_as<TI>(fwd[t * K + k]) : 0.f;
  }
  for (int i = tid; i < K * NP; i += NT) {
    const int k = i / NP;
    const int t = i - k * NP;
    cb[i] = t < n ? round_as<TI>(inv[k * n + t]) : 0.f;
  }
  for (int i = tid; i < L * n * C; i += NT) {
    const int l = i / (n * C);
    const int rem = i - l * n * C;
    const int t = rem / C;
    const int c = rem - t * C;
    const int g = line0 + l;
    float v = 0.f;
    if (g < n_lines) {
      const int b = g / lines_per_batch;
      const int a = g - b * lines_per_batch;
      v = to_f(x[b * batch_stride + a * line_stride + t * elem_stride + c]);
    }
    xs[i] = v;
  }
  __syncthreads();

  // 1. Spectra: s[l, c, k] = sum_t x[l, t, c] * et[t, k].
  for (int p = tid; p < L * C; p += NT) {
    const int l = p / C;
    const int c = p - l * C;
    const float* xl = xs + l * n * C + c;
    for (int k0 = 0; k0 < KP; k0 += KC) {
      float acc[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) acc[q] = 0.f;
      for (int t = 0; t < n; ++t) {
        const float xv = xl[t * C];
        const float4* e4 = reinterpret_cast<const float4*>(et + t * KP + k0);
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
          const float4 e = e4[q];
          acc[4 * q + 0] = fmaf(xv, e.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, e.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, e.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, e.w, acc[4 * q + 3]);
        }
      }
      float* sl = s + (l * C + c) * KS + k0;
#pragma unroll
      for (int q = 0; q < KC; ++q)
        if (k0 + q < K) sl[q] = round_as<TI>(acc[q]);
    }
  }
  __syncthreads();

  // 2. Per-mode complex mixing into y (which reuses the input lines' space).
  for (int p = tid; p < modes * C; p += NT) {
    const int o = p / modes;
    const int m = p - o * modes;
    float yr[L], yi[L];
#pragma unroll
    for (int l = 0; l < L; ++l) yr[l] = yi[l] = 0.f;
    const TW* wp = w + o * w_so + m * w_sm;
    for (int i = 0; i < C; ++i, wp += w_si) {
      float a, b;
      load_weight<TI>(wp, w_sp, pair, a, b);
      b *= wi_sign;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float sr = s[(l * C + i) * KS + m];
        const float si = s[(l * C + i) * KS + modes + m];
        yr[l] = fmaf(sr, a, fmaf(-si, b, yr[l]));
        yi[l] = fmaf(sr, b, fmaf(si, a, yi[l]));
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      y[(l * C + o) * KS + m] = round_as<TI>(yr[l]);
      y[(l * C + o) * KS + modes + m] = round_as<TI>(yi[l]);
    }
  }
  __syncthreads();

  // 3. Inverse: out[l, t, o] = sum_k y[l, o, k] * cb[k, t]; write or accumulate.
  for (int p = tid; p < L * C; p += NT) {
    const int l = p / C;
    const int o = p - l * C;
    const int g = line0 + l;
    if (g >= n_lines) continue;
    const int b = g / lines_per_batch;
    const int a = g - b * lines_per_batch;
    const int64_t base = b * batch_stride + a * line_stride + o;
    for (int t0 = 0; t0 < NP; t0 += KC) {
      float acc[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) acc[q] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float yv = y[(l * C + o) * KS + k];
        const float4* c4 = reinterpret_cast<const float4*>(cb + k * NP + t0);
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
          const float4 e = c4[q];
          acc[4 * q + 0] = fmaf(yv, e.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(yv, e.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(yv, e.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(yv, e.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        const int t = t0 + q;
        if (t < n) {
          const int64_t idx = base + t * elem_stride;
          float v = acc[q];
          if (prev != nullptr) v += prev[idx];
          out[idx] = from_f<TO>(v);
        }
      }
    }
  }
}

template <typename TI, typename TW, typename TO>
cudaError_t launch(const void* x, const void* fwd, const void* inv, const void* w,
                   int64_t w_si, int64_t w_so, int64_t w_sm, int64_t w_sp, bool conj,
                   const void* prev, void* out, int n_lines, int lines_per_batch, int64_t batch_stride,
                   int64_t line_stride, int64_t elem_stride, int n, int modes, int c,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(n, modes, c);
  cudaError_t err = cudaFuncSetAttribute(spectral_axis_kernel<TI, TW, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n_lines + L - 1) / L));
  const bool pair = w_sp == 1 && w_si % 2 == 0 && w_so % 2 == 0 && w_sm % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % (2 * sizeof(TW)) == 0;
  spectral_axis_kernel<TI, TW, TO><<<grid, NT, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const float*>(fwd), static_cast<const float*>(inv),
      static_cast<const TW*>(w), w_si, w_so, w_sm, w_sp, pair, conj ? -1.f : 1.f,
      static_cast<const float*>(prev),
      static_cast<TO*>(out), n_lines, lines_per_batch, batch_stride, line_stride, elem_stride, n,
      modes, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory bytes one block needs, for the wrapper's checks.
extern "C" long long spectral_axis_smem_bytes(int n, int modes, int c) {
  return (long long)(sizeof(float) * smem_floats(n, modes, c));
}

// Dtype codes: 0 = float32, 1 = bfloat16. x is float32 or bfloat16; w is
// float32 or x's type; out is float32, or bfloat16 when x is. w (i, o, m, part)
// is at w[i * w_si + o * w_so + m * w_sm + part * w_sp], part 0 real, 1
// imaginary; with conj != 0 the imaginary part is negated. prev may be null.
// Returns a cudaError_t (0 on success).
extern "C" int spectral_axis(int in_dtype, int w_dtype, int out_dtype, const void* x,
                             const void* fwd, const void* inv, const void* w, long long w_si,
                             long long w_so, long long w_sm, long long w_sp, int conj,
                             const void* prev, void* out, int n_lines, int lines_per_batch,
                             long long batch_stride, long long line_stride,
                             long long elem_stride, int n, int modes, int c, void* stream) {
  if (n_lines <= 0 || n <= 0 || modes <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define SPECTRAL_LAUNCH(TI, TW, TO)                                                         \
  return (int)launch<TI, TW, TO>(x, fwd, inv, w, w_si, w_so, w_sm, w_sp, conj != 0, prev, out, \
                                 n_lines, lines_per_batch, batch_stride, line_stride,          \
                                 elem_stride, n, modes, c, s)
  const int code = in_dtype * 4 + w_dtype * 2 + out_dtype;
  switch (code) {
    case 0: SPECTRAL_LAUNCH(float, float, float);  // f32 x, f32 w, f32 out
    case 4: SPECTRAL_LAUNCH(bf16, float, float);
    case 5: SPECTRAL_LAUNCH(bf16, float, bf16);
    case 6: SPECTRAL_LAUNCH(bf16, bf16, float);
    case 7: SPECTRAL_LAUNCH(bf16, bf16, bf16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_LAUNCH
}
