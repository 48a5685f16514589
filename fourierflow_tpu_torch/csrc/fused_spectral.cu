// One branch of the F-FNO spectral mix along one grid axis, forward pass:
//   out (+)= irdft_axis( W . rdft_axis(x) )
// with the truncated orthonormal real DFT, M modes and per-mode complex
// C_in x C_out channel mixing W = Wr + i Wi (C_out = C_in in the model; a
// column shard of the weights, C_out = C_in / tp, under tensor parallelism).
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
// Layout. A block of NT = 512 threads owns LB = 10 lines of one axis, so the
// flagship's 1,216 lines a launch (x [19, 64, 64, 64], M 16) make 122 blocks:
// one round on the H100's 132 SMs, one block an SM, no partial second round.
// A block walks the M modes in chunks of MC (mode_chunk below: all M where
// they fit, as at the flagship; else the largest multiple of 4 that fits,
// evened out: 16 of 32 at n 128, 12 of 64 and 8 of 16 at n 256), so that its
// shared memory depends on MC and not on M; the regions below hold one
// chunk, and M reads MC there.
// Shared memory (smem_layout below; every region a multiple of 16 bytes):
//   ws [WS][IC][CO][M][2] weight ring: WS = 2 stages of IC = 4 input
//                        channels, in the weights' own type (64 KiB in f32)
//   xr [XS][LB][TC][CI]  x ring: XS = 2 stages of TC = 8 samples of every
//                        line, in x's type (40 KiB in f32)
//   et [n][KP]           forward basis, columns interleaved (2m real, 2m + 1
//                        imaginary), zero-padded to KP (a multiple of 8)
//   cb [2M][NP]          inverse basis, rows interleaved, zero-padded to NP
//                        (a multiple of 8) samples
//   s  [LB][max(CI, CO)][KS] spectra [LB][CI], then the mixed spectra
//                        [LB][CO] over them; KS = 2 (M | 1), so a row is an
//                        odd number of 8-byte pairs and pair accesses of
//                        consecutive c fall in distinct banks
//   lb [LB]              each line's offset in x (int64)
// CI and CO are the input's and the output's channels (C_out of the weights,
// or C_in for the adjoint, which reads them transposed); each equals C in the
// model. At the flagship that is 65,536 + 40,960 + 8,192 + 8,192 + 87,040 +
// 80 = 210,000 bytes in f32 (189,520 for bf16 x, 156,752 for bf16 x and
// weights).
//
// Phases of a block:
// 1. Forward product s[l, c, k] = sum_t x[l, t, c] et[t, k]. x streams
//    through the ring by 16-byte cp.async (element loads where rows are not
//    16-byte pieces), the copy of chunk q + 1 in flight while chunk q is
//    used. Each thread's 16-byte pieces of a stage are fixed for the whole
//    kernel, so staging divides by nothing. A thread owns one c, LG = 5 lines and KC = 8 columns (40 sums in
//    registers): at the flagship exactly one item a thread. Wider spectra
//    take more passes over x.
// 2. Mix. A thread owns one mode m and P output channels o (o = og + j G,
//    G = NT / M; P = 2 at the flagship, 1 at C_out 32), for all LB lines, in
//    registers. The
//    weights stream through their ring in chunks of IC input channels by
//    cp.async (16-byte pieces of each contiguous (i, o) run of 2M values, or
//    one (re, im) pair a copy), chunk k + 1 in flight while chunk k mixes
//    (chunk 0 is copied during phase 1);
//    each chunk crosses L2 once a block and serves all LB lines. The i-sum
//    runs i = 0..CI-1 in order, yr = fma(sr, a, fma(-si, b, yr)). After a
//    barrier the mixed spectra overwrite s.
// 3. Inverse and store: out[l, t, o] = sum_k y[l, o, k] cb[k, t]; a thread
//    owns one o, LG lines and SC = 8 samples; warps store 32 consecutive o,
//    and the X launch loads all of its prev values before its first store.
// With more than one mode chunk the three phases run once a chunk: each
// chunk stages its bases, reads x again (the last forward step of a chunk
// starts the next one's first x chunk, the last mix step its first weight
// chunk), and phase 3 adds its inverse to a float32 partial sum `acc` of
// out's layout, which the owner of each element carries from chunk to chunk
// (prev, or nothing, starts it; the last chunk stores out). At n 256 and M
// 64 that is 6 chunks: x read 6 times and acc read and written 5 times.
//
// L2 traffic an axis launch at the flagship, f32: the weights 122 x 512 KiB
// = 64.0 MB in bulk copies (the first version read them 304 times, 159 MB,
// one scalar pair load per 16 FMAs), x 19.9 MB once, out 19.9 MB (and prev
// 19.9 MB on the X branch). Bound of a call (both launches) at the flagship:
// 2.55 GFLOP against 39.8 MB (f32), memory-bound in bf16 and close to
// balanced in f32 on tensor cores; this kernel's arithmetic is 0.64 G FMA
// an axis launch on CUDA cores, about 23 us at one block an SM.
//
// The adjoint (the gradient with respect to x; the TPU package's
// _fused_mix_bwd launches its kernel a second time in the same way) is this
// kernel on the adjoint operator: the forward basis becomes the inverse
// basis transposed and the inverse basis the forward one transposed (the
// wrapper passes cached contiguous transposes; they carry irdft's Hermitian
// weights, so the adjoint is no forward rDFT), the weights are read
// (i, o)-transposed by swapping the w_si and w_so strides (still runs of 2M
// contiguous values), and `conj` negates the imaginary weight in the mix.
// Its bound is the forward's.
//
// Types: x is float or bf16; the mode weights are float or x's type, and are
// rounded to x's type as they are read (as the plain version casts them).
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

constexpr int NT = 512;   // threads per block
constexpr int LB = 10;    // lines per block
constexpr int LG = 5;     // lines per thread in the forward and inverse products
constexpr int KC = 8;     // spectrum columns per thread in the forward product
constexpr int SC = 8;     // samples per thread in the inverse product
constexpr int TC = 8;     // samples of every line per x stage
constexpr int XS = 2;     // x stages (copies XS - 1 chunks ahead)
constexpr int IC = 4;     // input channels per weight stage
constexpr int WS = 2;     // weight stages (copies WS - 1 chunks ahead)
constexpr int PMAX = 3;   // output channels per thread and mode in the mix, at most
constexpr int kMaxSmem = 232448;  // bytes of shared memory one block may use
static_assert(LB % LG == 0, "lines split into whole groups");

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

// Real and imaginary part of one staged mode weight, as x's type TI would
// hold them, in f32.
template <typename TI>
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = round_as<TI>(v.x), b = round_as<TI>(v.y);
}
template <typename TI>
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v), b = __high2float(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Byte offsets of the shared-memory regions (see the header), for a chunk
// of `chunk` modes.
struct SmemLayout {
  int K, KP, KS, NP;
  size_t ws, xr, et, cb, s, lb, total;
};
__host__ __device__ __forceinline__ SmemLayout smem_layout(int n, int chunk, int ci, int co,
                                                           int x_size, int w_size) {
  SmemLayout L;
  L.K = 2 * chunk;
  L.KP = round_up(L.K, KC);
  L.KS = 2 * (chunk | 1);
  L.NP = round_up(n, SC);
  L.ws = 0;
  L.xr = L.ws + (size_t)WS * IC * co * L.K * w_size;
  L.et = L.xr + (size_t)XS * LB * TC * ci * x_size;
  L.cb = L.et + (size_t)n * L.KP * 4;
  L.s = L.cb + (size_t)L.K * L.NP * 4;
  L.lb = L.s + (size_t)LB * (ci > co ? ci : co) * L.KS * 4;
  L.total = L.lb + (size_t)LB * 8;
  return L;
}

// Output channels per thread and mode in the mix (0 if C_out is too wide).
__host__ __device__ __forceinline__ int mix_pairs(int chunk, int co) {
  const int g = NT / chunk;
  const int pr = g > 0 ? (co + g - 1) / g : PMAX + 1;
  return pr <= PMAX ? pr : 0;
}

// Modes a block takes at once: all M where that fits in shared memory and
// the mix's thread mapping; else the largest multiple of 4 that fits (or 3,
// 2, 1), evened out over the chunks it needs (M 64 at n 256: 12 x 5 + 4).
// 0 if not even one mode fits.
int mode_chunk(int n, int modes, int ci, int co, int x_size, int w_size) {
  auto fits = [&](int mc) {
    return smem_layout(n, mc, ci, co, x_size, w_size).total <= (size_t)kMaxSmem &&
           mix_pairs(mc, co) > 0;
  };
  if (fits(modes)) return modes;
  int best = 0;
  for (int mc = 4; mc < modes; mc += 4)
    if (fits(mc)) best = mc;
  for (int mc = modes - 1 < 3 ? modes - 1 : 3; best == 0 && mc >= 1; --mc)
    if (fits(mc)) best = mc;
  if (best == 0) return 0;
  const int chunks = (modes + best - 1) / best;
  const int even = round_up((modes + chunks - 1) / chunks, 4);
  return even < best ? even : best;
}

template <typename TI, typename TW, typename TO>
struct Params {
  const TI* x;
  const float* fwd;
  const float* inv;
  const TW* w;  // (i, o, m, part) at w[i * w_si + o * w_so + 2 m + part]
  int64_t w_si, w_so;
  float wi_sign;
  bool x_vec, w_vec;  // stage x / the weights in 16-byte pieces
  const float* prev;
  float* acc;  // the output's partial sums between mode chunks (f32, out's layout)
  TO* out;  // prev and acc have out's layout
  int n_lines, lines_per_batch;
  int64_t batch_stride, line_stride, elem_stride;        // of x
  int64_t o_batch_stride, o_line_stride, o_elem_stride;  // of out
  int n, modes, chunk, ci, co;
};

template <typename TI, typename TW, typename TO, int P>
__global__ void __launch_bounds__(NT, 1) spectral_axis_kernel(const Params<TI, TW, TO> p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int n = p.n, M = p.modes, MC = p.chunk, CI = p.ci, CO = p.co;
  const int nch = (M + MC - 1) / MC;  // mode chunks
  const SmemLayout L = smem_layout(n, MC, CI, CO, sizeof(TI), sizeof(TW));
  const int K = L.K, KP = L.KP, KS = L.KS, NP = L.NP;  // of a whole chunk
  TW* ws = reinterpret_cast<TW*>(smem + L.ws);
  TI* xr = reinterpret_cast<TI*>(smem + L.xr);
  float* et = reinterpret_cast<float*>(smem + L.et);
  float* cb = reinterpret_cast<float*>(smem + L.cb);
  float* s = reinterpret_cast<float*>(smem + L.s);

  const int tid = threadIdx.x;
  const int line0 = blockIdx.x * LB;
  const int x_stage = LB * TC * CI;  // elements of one x stage
  const int w_stage = IC * CO * K;   // elements of one weight stage
  const int nq_t = (n + TC - 1) / TC;
  // The forward product's items (line group, column chunk, c) and passes.
  const int kch = KP / KC;
  const int items = (LB / LG) * kch * CI;
  const int passes = (items + NT - 1) / NT;
  const int nq = nch * passes * nq_t;  // x chunks over all passes and mode chunks
  const int nk = (CI + IC - 1) / IC;   // weight chunks of a mode chunk

  // Offset in x of each line of the block (sample 0, channel 0), -1 past
  // n_lines; phase 3 computes the lines' offsets in out from their index.
  int64_t* lbase = reinterpret_cast<int64_t*>(smem + L.lb);
  if (tid < LB) {
    const int g = line0 + tid;
    const int b = g / p.lines_per_batch;
    lbase[tid] =
        g < p.n_lines ? b * p.batch_stride + (g - b * p.lines_per_batch) * p.line_stride : -1;
  }
  __syncthreads();

  // Each thread's share of an x stage is fixed for the whole kernel, so that
  // staging x divides by nothing: the 16-byte column xe of the rows
  // xrow0 + j rsx.
  constexpr int EX = 16 / sizeof(TI), EW = 16 / sizeof(TW);
  const int px = max(CI / EX, 1);  // pieces of a row
  const int rsx = NT / px;
  const int xe = tid % px * EX, xrow0 = tid / px;

  // Start the copy of x chunk q < nq (samples TC (q % nq_t) onwards of every
  // line; every mode chunk reads x again) into stage q % XS; lines past
  // n_lines are zero-filled. One commit group, empty for q >= nq.
  auto stage_x = [=](int q) {
    if (q < nq) {
      const int t0 = (q % nq_t) * TC;
      const int rows = min(TC, n - t0);
      TI* dst = xr + (q % XS) * x_stage;
      if (p.x_vec) {
        for (int r = xrow0; r < LB * TC && xrow0 < rsx; r += rsx) {
          const int tt = r % TC;
          const int64_t base = lbase[r / TC];
          if (tt >= rows) continue;
          const bool on = base >= 0;
          cp_async16(dst + r * CI + xe, on ? p.x + base + (t0 + tt) * p.elem_stride + xe : p.x,
                     on ? 16 : 0);
        }
      } else {
        for (int i = tid; i < LB * rows * CI; i += NT) {
          const int l = i / (rows * CI);
          const int rem = i - l * rows * CI;
          const int tt = rem / CI;
          const int c = rem - tt * CI;
          const int64_t base = lbase[l];
          dst[(l * TC + tt) * CI + c] =
              base >= 0 ? p.x[base + (t0 + tt) * p.elem_stride + c] : from_f<TI>(0.f);
        }
      }
    }
    cp_async_commit();
  };

  // A whole mode chunk's share of a weight stage for each thread, fixed for
  // the whole kernel: the 16-byte piece we of the runs wrun0 + j rsw (runs
  // of 2 MC values), the first at (wi0, wo0), each rsw runs on (wdi, wdo).
  const int pw = max(K / EW, 1), rsw = NT / pw;
  const int we = tid % pw * EW, wrun0 = tid / pw;
  const int wi0 = wrun0 / CO, wo0 = wrun0 - wi0 * CO;
  const int wdi = rsw / CO, wdo = rsw - wdi * CO;

  // Start the copy of weight chunk k (input channels IC k onwards) of mode
  // chunk ch < nch into stage (ch nk + k) % WS, laid out [i][o][MC][2]
  // (CO runs of each of IC input channels). One
  // commit group, empty for ch >= nch.
  auto stage_w = [=](int ch, int k) {
    if (ch < nch) {
      const int i0 = k * IC;
      const int ni = min(IC, CI - i0);
      const int m0 = ch * MC, mc = min(MC, M - m0);
      TW* dst = ws + ((ch * nk + k) % WS) * w_stage;
      const TW* src = p.w + i0 * p.w_si + 2 * m0;
      if (p.w_vec && (2 * mc) % EW == 0) {
        int e = we, r0 = wrun0, rs = rsw, di = wdi, dd = wdo, ii = wi0, o = wo0;
        if (mc != MC) {  // a last, shorter chunk: its own share
          const int pl = 2 * mc / EW;
          rs = NT / pl, e = tid % pl * EW, r0 = tid / pl;
          di = rs / CO, dd = rs - di * CO, ii = r0 / CO, o = r0 - ii * CO;
        }
        for (int r = r0; r < ni * CO && r0 < rs; r += rs) {
          cp_async16(dst + r * K + e, src + ii * p.w_si + o * p.w_so + e, 16);
          ii += di, o += dd;
          if (o >= CO) o -= CO, ++ii;
        }
      } else {
        for (int i = tid; i < ni * CO * mc; i += NT) {
          const int run = i / mc;
          const int m = i - run * mc;
          const int ii = run / CO;
          const int o = run - ii * CO;
          cp_async_ca<(int)(2 * sizeof(TW))>(dst + run * K + 2 * m,
                                             src + ii * p.w_si + o * p.w_so + 2 * m);
        }
      }
    }
    cp_async_commit();
  };

  // Commit order: x chunks 0..XS-2, then weight chunks 0..WS-2; in the loops
  // each step commits one group, so the waits below count groups exactly. The
  // last forward step of a mode chunk starts the next one's first x chunk,
  // the last mix step its first weight chunk: the first forward step of
  // every mode chunk sees the same groups behind its x chunk as chunk 0's.
  for (int q = 0; q < XS - 1; ++q) stage_x(q);
  static_assert(WS == 2, "the mix loop starts the next weight chunk only");
  stage_w(0, 0);

  int q = 0;  // x chunk
  for (int ch = 0; ch < nch; ++ch) {
    const int m0 = ch * MC, mc = min(MC, M - m0);
    const int kc2 = 2 * mc;  // spectrum columns of this chunk
    if (ch > 0) __syncthreads();  // the last chunk's inverse is done with cb and s
    // This chunk's bases: the forward one's columns, the inverse one's rows.
    for (int i = tid; i < n * KP; i += NT) {
      const int t = i / KP;
      const int k = i - t * KP;
      et[i] = k < kc2 ? round_as<TI>(p.fwd[t * 2 * M + (k & 1) * M + m0 + (k >> 1)]) : 0.f;
    }
    for (int i = tid; i < K * NP; i += NT) {
      const int k = i / NP;
      const int t = i - k * NP;
      cb[i] = t < n && k < kc2 ? round_as<TI>(p.inv[((k & 1) * M + m0 + (k >> 1)) * n + t]) : 0.f;
    }

    // 1. Forward product. Item (group, column chunk, c), c fastest.
    for (int pass = 0; pass < passes; ++pass) {
      const int item = tid + pass * NT;
      const bool active = item < items;
      const int c = item % CI;
      const int kc = (item / CI) % kch;
      const int grp = item / (CI * kch);
      float acc[LG][KC];
#pragma unroll
      for (int l = 0; l < LG; ++l)
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[l][j] = 0.f;
      for (int tq = 0; tq < nq_t; ++tq, ++q) {
        // x chunk q has landed once at most the groups committed after it
        // are pending: before a mode chunk's first those include the weight
        // chunks.
        if (pass == 0 && tq < XS - 1)
          cp_async_wait<XS + WS - 3>();
        else
          cp_async_wait<XS - 2>();
        __syncthreads();  // ... for every thread; stage (q - 1) % XS is free
        stage_x(q + XS - 1);
        if (!active) continue;
        const int rows = min(TC, n - tq * TC);
        const TI* xb = xr + (q % XS) * x_stage + grp * LG * TC * CI + c;
        const float* eb = et + tq * TC * KP + kc * KC;
#pragma unroll
        for (int tt = 0; tt < TC; ++tt) {
          if (tt < rows) {
            const float4 e0 = *reinterpret_cast<const float4*>(eb + tt * KP);
            const float4 e1 = *reinterpret_cast<const float4*>(eb + tt * KP + 4);
#pragma unroll
            for (int l = 0; l < LG; ++l) {
              const float xv = to_f(xb[(l * TC + tt) * CI]);
              acc[l][0] = fmaf(xv, e0.x, acc[l][0]);
              acc[l][1] = fmaf(xv, e0.y, acc[l][1]);
              acc[l][2] = fmaf(xv, e0.z, acc[l][2]);
              acc[l][3] = fmaf(xv, e0.w, acc[l][3]);
              acc[l][4] = fmaf(xv, e1.x, acc[l][4]);
              acc[l][5] = fmaf(xv, e1.y, acc[l][5]);
              acc[l][6] = fmaf(xv, e1.z, acc[l][6]);
              acc[l][7] = fmaf(xv, e1.w, acc[l][7]);
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int l = 0; l < LG; ++l) {
          float* sl = s + ((grp * LG + l) * CI + c) * KS + kc * KC;
#pragma unroll
          for (int j = 0; j < KC; j += 2)
            if (kc * KC + j < K)
              *reinterpret_cast<float2*>(sl + j) =
                  make_float2(round_as<TI>(acc[l][j]), round_as<TI>(acc[l][j + 1]));
        }
      }
    }

    // 2. Per-mode complex mix, weights streamed through the ring.
    {
      const int G = NT / MC;
      const int m = tid % MC;
      const int og = tid / MC;
      const bool mixer = og < G && m < mc;
      float yr[P][LB], yi[P][LB];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int l = 0; l < LB; ++l) yr[j][l] = yi[j][l] = 0.f;
      for (int k = 0; k < nk; ++k) {
        // Weight chunk k: all but the WS - 2 newest groups done.
        if (k == 0)
          cp_async_wait<0>();
        else
          cp_async_wait<WS - 2>();
        __syncthreads();  // ... for every thread; s complete; the other stage is free
        if (k + 1 < nk)
          stage_w(ch, k + 1);
        else
          stage_w(ch + 1, 0);
        if (!mixer) continue;
        const TW* wst = ws + ((ch * nk + k) % WS) * w_stage;
        const int ni = min(IC, CI - k * IC);
#pragma unroll
        for (int ii = 0; ii < IC; ++ii) {
          if (ii >= ni) break;
          const int i = k * IC + ii;
          float a[P], b[P];
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const int o = og + j * G;
            a[j] = b[j] = 0.f;
            if (o < CO) load_pair<TI>(wst + ((ii * CO + o) * MC + m) * 2, a[j], b[j]);
            b[j] *= p.wi_sign;
          }
          const float* sp = s + i * KS + 2 * m;
#pragma unroll
          for (int l = 0; l < LB; ++l) {
            const float2 sv = *reinterpret_cast<const float2*>(sp + l * CI * KS);
#pragma unroll
            for (int j = 0; j < P; ++j) {
              yr[j][l] = fmaf(sv.x, a[j], fmaf(-sv.y, b[j], yr[j][l]));
              yi[j][l] = fmaf(sv.x, b[j], fmaf(sv.y, a[j], yi[j][l]));
            }
          }
        }
      }
      __syncthreads();  // every spectrum read: the mixed spectra go over them
      if (mixer) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int o = og + j * G;
          if (o >= CO) continue;
#pragma unroll
          for (int l = 0; l < LB; ++l)
            *reinterpret_cast<float2*>(s + (l * CO + o) * KS + 2 * m) =
                make_float2(round_as<TI>(yr[j][l]), round_as<TI>(yi[j][l]));
        }
      }
      __syncthreads();
    }

    // 3. Inverse and store. Item (group, sample chunk, o), o fastest; each
    // output element has one owner in every mode chunk, which carries its
    // partial sum from chunk to chunk in acc.
    const bool first = ch == 0, last = ch == nch - 1;
    const float* base_in = first ? p.prev : p.acc;  // may be null on the first chunk
    const int tch = NP / SC;
    for (int item = tid; item < (LB / LG) * tch * CO; item += NT) {
      const int o = item % CO;
      const int tc = (item / CO) % tch;
      const int grp = item / (CO * tch);
      float acc[LG][SC];
#pragma unroll
      for (int l = 0; l < LG; ++l)
#pragma unroll
        for (int j = 0; j < SC; ++j) acc[l][j] = 0.f;
      const float* yb = s + (grp * LG * CO + o) * KS;
      const float* cbt = cb + tc * SC;
      for (int m = 0; m < mc; ++m) {
        float2 yv[LG];
#pragma unroll
        for (int l = 0; l < LG; ++l)
          yv[l] = *reinterpret_cast<const float2*>(yb + l * CO * KS + 2 * m);
#pragma unroll
        for (int h = 0; h < SC; h += 4) {
          const float4 er = *reinterpret_cast<const float4*>(cbt + 2 * m * NP + h);
          const float4 ei = *reinterpret_cast<const float4*>(cbt + (2 * m + 1) * NP + h);
#pragma unroll
          for (int l = 0; l < LG; ++l) {
            acc[l][h + 0] = fmaf(yv[l].y, ei.x, fmaf(yv[l].x, er.x, acc[l][h + 0]));
            acc[l][h + 1] = fmaf(yv[l].y, ei.y, fmaf(yv[l].x, er.y, acc[l][h + 1]));
            acc[l][h + 2] = fmaf(yv[l].y, ei.z, fmaf(yv[l].x, er.z, acc[l][h + 2]));
            acc[l][h + 3] = fmaf(yv[l].y, ei.w, fmaf(yv[l].x, er.w, acc[l][h + 3]));
          }
        }
      }
      int64_t base[LG];  // of each line's sample 0, channel o in out; -1 past n_lines
#pragma unroll
      for (int l = 0; l < LG; ++l) {
        const int g = line0 + grp * LG + l;
        const int b = g / p.lines_per_batch;
        base[l] = g < p.n_lines
                      ? b * p.o_batch_stride + (g - b * p.lines_per_batch) * p.o_line_stride + o
                      : -1;
      }
      // All of prev (or acc) is loaded before any store (out and acc may
      // alias it, for all the compiler knows, which would put each load
      // behind the previous store).
      if (base_in != nullptr) {
#pragma unroll
        for (int l = 0; l < LG; ++l)
#pragma unroll
          for (int j = 0; j < SC; ++j)
            if (base[l] >= 0 && tc * SC + j < n)
              acc[l][j] += base_in[base[l] + (tc * SC + j) * p.o_elem_stride];
      }
      if (last) {
#pragma unroll
        for (int l = 0; l < LG; ++l)
#pragma unroll
          for (int j = 0; j < SC; ++j)
            if (base[l] >= 0 && tc * SC + j < n)
              p.out[base[l] + (tc * SC + j) * p.o_elem_stride] = from_f<TO>(acc[l][j]);
      } else {
#pragma unroll
        for (int l = 0; l < LG; ++l)
#pragma unroll
          for (int j = 0; j < SC; ++j)
            if (base[l] >= 0 && tc * SC + j < n)
              p.acc[base[l] + (tc * SC + j) * p.o_elem_stride] = acc[l][j];
      }
    }
  }
}

template <typename TI, typename TW, typename TO, int P>
cudaError_t launch_p(const Params<TI, TW, TO>& p, size_t smem, cudaStream_t stream) {
  // The opt-in to more than 48 KB of shared memory, once per instance.
  static const cudaError_t attr = cudaFuncSetAttribute(
      spectral_axis_kernel<TI, TW, TO, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)((p.n_lines + LB - 1) / LB));
  spectral_axis_kernel<TI, TW, TO, P><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

template <typename TI, typename TW, typename TO>
cudaError_t launch(const void* x, const void* fwd, const void* inv, const void* w,
                   int64_t w_si, int64_t w_so, int64_t w_sm, int64_t w_sp, bool conj,
                   const void* prev, void* acc, void* out, int n_lines, int lines_per_batch,
                   int64_t batch_stride, int64_t line_stride, int64_t elem_stride,
                   int64_t o_batch_stride, int64_t o_line_stride, int64_t o_elem_stride, int n,
                   int modes, int ci, int co, cudaStream_t stream) {
  const int chunk = mode_chunk(n, modes, ci, co, sizeof(TI), sizeof(TW));
  if (chunk == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_layout(n, chunk, ci, co, sizeof(TI), sizeof(TW)).total;
  const int pairs = mix_pairs(chunk, co);
  // Every (i, o) run of 2M weights must be contiguous and (re, im)-aligned;
  // more than one mode chunk needs the partial-sum array.
  const int wpair = 2 * sizeof(TW);
  if (w_sp != 1 || w_sm != 2 || (w_si * (int64_t)sizeof(TW)) % wpair ||
      (w_so * (int64_t)sizeof(TW)) % wpair || !aligned(w, wpair) ||
      (chunk < modes && acc == nullptr))
    return cudaErrorInvalidValue;
  Params<TI, TW, TO> p;
  p.x = static_cast<const TI*>(x);
  p.fwd = static_cast<const float*>(fwd);
  p.inv = static_cast<const float*>(inv);
  p.w = static_cast<const TW*>(w);
  p.w_si = w_si, p.w_so = w_so;
  p.wi_sign = conj ? -1.f : 1.f;
  const int64_t ex = 16 / sizeof(TI), ew = 16 / sizeof(TW);
  p.x_vec = ci % ex == 0 && ci / ex <= NT && batch_stride % ex == 0 && line_stride % ex == 0 &&
            elem_stride % ex == 0 && aligned(x, 16);
  // Chunk offsets 2 m0 are then whole pieces too; a last, shorter chunk
  // whose runs are not is staged a pair a copy.
  p.w_vec = (2 * chunk) % ew == 0 && 2 * chunk / ew <= NT && w_si % ew == 0 && w_so % ew == 0 &&
            aligned(w, 16);
  p.prev = static_cast<const float*>(prev);
  p.acc = static_cast<float*>(acc);
  p.out = static_cast<TO*>(out);
  p.n_lines = n_lines, p.lines_per_batch = lines_per_batch;
  p.batch_stride = batch_stride, p.line_stride = line_stride, p.elem_stride = elem_stride;
  p.o_batch_stride = o_batch_stride, p.o_line_stride = o_line_stride;
  p.o_elem_stride = o_elem_stride;
  p.n = n, p.modes = modes, p.chunk = chunk, p.ci = ci, p.co = co;
  switch (pairs) {
    case 1: return launch_p<TI, TW, TO, 1>(p, smem, stream);
    case 2: return launch_p<TI, TW, TO, 2>(p, smem, stream);
    default: return launch_p<TI, TW, TO, 3>(p, smem, stream);
  }
}

int dtype_size(int code) { return code == 0 ? 4 : 2; }

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Modes of one chunk (mode_chunk; 0 if none fits) and the shared memory
// bytes one block needs at that chunk (dtype codes as below), for the
// wrapper's checks.
extern "C" int spectral_axis_mode_chunk(int in_dtype, int w_dtype, int n, int modes, int c_in,
                                        int c_out) {
  return mode_chunk(n, modes, c_in, c_out, dtype_size(in_dtype), dtype_size(w_dtype));
}
extern "C" long long spectral_axis_smem_bytes(int in_dtype, int w_dtype, int n, int modes,
                                              int c_in, int c_out) {
  const int chunk = mode_chunk(n, modes, c_in, c_out, dtype_size(in_dtype), dtype_size(w_dtype));
  return (long long)smem_layout(n, chunk > 0 ? chunk : modes, c_in, c_out, dtype_size(in_dtype),
                                dtype_size(w_dtype)).total;
}

// Dtype codes: 0 = float32, 1 = bfloat16. x is float32 or bfloat16; w is
// float32 or x's type; out is float32, or bfloat16 when x is. w (i, o, m, part)
// is at w[i * w_si + o * w_so + m * w_sm + part * w_sp], part 0 real, 1
// imaginary; the kernel takes w_sm = 2, w_sp = 1 (each (i, o) run of 2M
// values contiguous) with w_si, w_so even and w aligned to a (re, im) pair.
// With conj != 0 the imaginary part is negated. x has c_in channels and out
// c_out, each with its own strides (out's o_*; i runs over c_in and o over
// c_out in w's indexing). prev may be null. acc is a float32 array of out's
// layout that holds the partial sums between mode chunks; it may be prev or
// out (when out is float32) and may be null when all modes fit in one chunk
// (spectral_axis_mode_chunk == modes). Takes what fits in 232,448 bytes of
// shared memory with at least one mode a chunk and c_out <= 3 (512 / chunk).
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for anything
// it does not take).
extern "C" int spectral_axis(int in_dtype, int w_dtype, int out_dtype, const void* x,
                             const void* fwd, const void* inv, const void* w, long long w_si,
                             long long w_so, long long w_sm, long long w_sp, int conj,
                             const void* prev, void* acc, void* out, int n_lines,
                             int lines_per_batch, long long batch_stride, long long line_stride,
                             long long elem_stride, long long o_batch_stride,
                             long long o_line_stride, long long o_elem_stride, int n, int modes,
                             int c_in, int c_out, void* stream) {
  if (n_lines <= 0 || n <= 0 || modes <= 0 || c_in <= 0 || c_out <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define SPECTRAL_LAUNCH(TI, TW, TO)                                                             \
  return (int)launch<TI, TW, TO>(x, fwd, inv, w, w_si, w_so, w_sm, w_sp, conj != 0, prev, acc, \
                                 out, n_lines, lines_per_batch, batch_stride, line_stride,      \
                                 elem_stride, o_batch_stride, o_line_stride, o_elem_stride, n,  \
                                 modes, c_in, c_out, s)
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
