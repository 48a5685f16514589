// Fused two-layer feed-forward: out = relu(x @ W1 + b1) @ W2 + b2, forward
// (ff_fwd) and backward (ff_bwd, described after the forward kernel).
//
// Forward. Replaces the TPU kernel fourierflow_tpu/ops/pallas_ff.py::_ff_kernel
// (launched by _ff_pallas), which keeps a [1024, 4C] hidden tile in VMEM.
//
// What bounds it at the flagship (rows 77,824, C_in = C_out = 64, H = 256):
// 5.10 GFLOP against 19.9 MB in bf16 (39.8 MB in f32). In bf16 that is 256
// FLOP per byte, under the H100's 295, so on tensor cores it is bound by
// memory (6.0 us); in f32, done to f32 accuracy on tensor cores as three
// TF32 products (495/3 TFLOP/s), by operations (31 us).
//
// Design. Both products run on tensor cores through warp-level mma.sync:
// m16n8k16 bf16 with f32 sums, and in f32 m16n8k8 TF32 with the 3xTF32
// split a = a_hi + a_lo (a_hi keeps the top 11 significant bits, a_lo the
// exact remainder, itself truncated to TF32 by the tensor core), summing
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32. That keeps f32 accuracy; one
// TF32 product keeps about three digits.
// - The grid is persistent (the blocks that fit on the card at once). A
//   block stages all of W1 and W2 in shared memory once, through 16-byte
//   cp.async where the weights' inner stride is 1 (the model's weight.t()
//   views), so the weights cross L2 once per block, not once per tile.
//   Rows are padded by 8 elements, which puts the fragment loads of a warp
//   on distinct banks. Narrower C_in and C_out are zero-padded to 64 there,
//   so the unrolled fragment loops carry no runtime bound (such bounds
//   split them into blocks the compiler would not schedule across).
// - Each warp owns tiles of WR = 16*MT rows (tile blockIdx.x + gridDim.x *
//   (warp + NW*k), so every SM gets an even share). The warp loads its
//   tile's x fragments into registers, then at once starts the cp.async of
//   its next tile into the same shared buffer (16 bytes a thread, the
//   ragged tail zero-filled), which lands while this tile computes.
// - The hidden layer never leaves registers. For each chunk of 64 hidden
//   columns the warp forms h = relu(x @ W1[:, chunk] + b1) in f32 fragments;
//   in bf16 they are rounded to bf16 (as the JAX kernel rounds h to x's
//   type) and repacked as the A fragments of h @ W2[chunk, :], as
//   FlashAttention-2 does for P*V; the B fragments of both products come
//   two n-tiles at a time from ldmatrix. In f32 the m16n8k8 accumulator holds
//   columns 2t, 2t+1 where an A fragment wants t, t+4: the kernel permutes
//   the depth of every TF32 product (logical k = t and t+4 are physical 2t
//   and 2t+1, in A and B alike), which leaves each sum unchanged and lets
//   the accumulator be used as A where it stands and x and W be read as
//   float2.
// - The epilogue adds b2, rounds to x's type and stores two columns per
//   thread; rows past `rows` are not stored.
// - H a multiple of 16 but not of 64 (the hidden slice of a tensor-parallel
//   rank: 256 / 8 = 32 at the flagship, 128 / 8 = 16 at elasticity) is
//   staged rounded up to whole 64-wide chunks, the W1 rows, W2 columns and b1
//   past H as zeros: those columns give h = relu(0) = 0 and add nothing, so
//   the last chunk needs no bound of its own. Nothing steps through H by less
//   than a chunk; H a multiple of 16 keeps each staged W2 row (H values) a
//   whole number of 16-byte copies in f32 and bf16 (stage_matrix).
// Shapes: C_in a multiple of 16 and <= 64, H a multiple of 16 (H_STEP), C_out
// a multiple of 8 and <= 64, and the shared memory of fwd_smem_bytes (H
// counted rounded up to a multiple of 64). x (16-byte aligned), biases and
// out are contiguous; W1 [C_in, H] and W2 [H, C_out] are read through
// element strides.
//
// Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;          // threads per block of the backward kernels
constexpr int MAX_SMEM = 232448; // bytes of shared memory one block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// --- forward -----------------------------------------------------------------
constexpr int HC = 64;           // hidden columns per chunk; H is staged rounded up to it
constexpr int H_STEP = 16;       // both kernels take H in multiples of this
constexpr int MAX_C = 64;        // C_in and C_out bound: fragments live in registers
constexpr int PAD = 8;           // elements of padding per staged row

// Warps of a block and m16 tiles of a warp tile (WR = 16 * m_tiles rows):
// two in bf16, where each B fragment then feeds two products; one in f32,
// whose x fragments (hi and lo) take twice the registers.
template <typename T> struct FwdShape;
template <> struct FwdShape<float> {
  static constexpr int warps = 8, m_tiles = 1;
};
template <> struct FwdShape<__nv_bfloat16> {
  static constexpr int warps = 8, m_tiles = 2;
};

// H rounded up to whole chunks: the hidden columns a forward block stages.
__host__ __device__ __forceinline__ int fwd_staged_hidden(int hidden) {
  return (hidden + HC - 1) / HC * HC;
}

template <typename T>
__host__ __device__ __forceinline__ size_t fwd_smem_bytes(int hidden, int cout) {
  const size_t hp = fwd_staged_hidden(hidden);
  const size_t elems = (size_t)FwdShape<T>::warps * 16 * FwdShape<T>::m_tiles * (MAX_C + PAD) +
                       hp * (MAX_C + PAD) + (size_t)MAX_C * (hp + PAD);
  return elems * sizeof(T) + sizeof(float) * (hp + (size_t)cout);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 ld_f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8 and receives, from matrix i, row l / 4 and columns
// 2 (l % 4), +1 in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b on one m16n8k16 bf16 tile, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b on one m16n8k8 TF32 tile, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v = hi + lo exactly; hi is v with its low 13 mantissa bits cleared (a TF32 value).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += (a_hi + a_lo)(b_hi + b_lo), dropping a_lo b_lo.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// dst[r * ld + c] = src[r * s_row + c * s_col] for r < n_rows, c < n_cols
// (n_cols a multiple of 8), by the whole block: 16-byte cp.async where rows
// are contiguous and aligned, else element by element.
template <typename T>
__device__ void stage_matrix(T* dst, int ld, const T* src, int n_rows, int n_cols, int s_row,
                             int s_col) {
  constexpr int V = 16 / sizeof(T);
  if (s_col == 1 && s_row % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_row = n_cols / V;
    for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int v = i - r * per_row;
      cp_async16(dst + r * ld + v * V, src + (int64_t)r * s_row + v * V, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * n_cols; i += blockDim.x) {
      const int r = i / n_cols;
      const int c = i - r * n_cols;
      dst[r * ld + c] = src[(int64_t)r * s_row + (int64_t)c * s_col];
    }
  }
}

// Start the cp.async of warp tile `tile` (WR rows of x) into xs, by one warp;
// rows past `rows` are zero-filled.
template <typename T, int WR>
__device__ __forceinline__ void load_x_tile(T* xs, int ldx, const T* __restrict__ x, int tile,
                                            int rows, int cin, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cin / V;
  const int64_t row0 = (int64_t)tile * WR;
  for (int i = lane; i < WR * per_row; i += 32) {
    const int r = i / per_row;
    const int v = i - r * per_row;
    const bool in = row0 + r < rows;
    cp_async16(xs + r * ldx + v * V, in ? x + (row0 + r) * cin + v * V : x, in ? 16 : 0);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&v)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[n][e] = 0.f;
}
template <int M, int N>
__device__ __forceinline__ void zero(float (&v)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[m][n][e] = 0.f;
}

// acc += relu(x @ W1 + b1) @ W2 for one warp tile, bf16: x in the A
// fragments xa, the weights and b1 in shared memory.
template <int MT>
__device__ __forceinline__ void ff_fwd_products(const __nv_bfloat16* w1s,
                                                const __nv_bfloat16* w2s, const float* b1s,
                                                int hidden, int ldw2, int lane,
                                                const uint32_t (&xa)[MT][MAX_C / 16][4],
                                                float (&acc)[MT][MAX_C / 8][4]) {
  constexpr int ldw1 = MAX_C + PAD;
  const int g = lane / 4, t = lane % 4;
  // B fragments come in pairs of n-tiles from one ldmatrix: matrices 0, 1
  // are the two depth halves of n-tile j, matrices 2, 3 those of j + 1.
  const int lrow = lane % 8 + 8 * (lane / 16), lcol = 8 * (lane / 8 % 2);
  for (int h0 = 0; h0 < hidden; h0 += HC) {
    float hc[MT][HC / 8][4];
    zero(hc);
#pragma unroll
    for (int kk = 0; kk < MAX_C / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < HC / 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, w1s + (h0 + 8 * j + lrow) * ldw1 + kk * 16 + lcol);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(hc[m][j], xa[m][kk], b0);
          mma_bf16(hc[m][j + 1], xa[m][kk], b1);
        }
      }
    }
    // h = relu(. + b1), rounded to bf16; n-tiles 2s and 2s+1 make the A
    // fragment of depth step s.
    uint32_t ha[MT][HC / 16][4];
#pragma unroll
    for (int j = 0; j < HC / 8; ++j) {
      const float bb0 = b1s[h0 + 8 * j + 2 * t], bb1 = b1s[h0 + 8 * j + 2 * t + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ha[m][j / 2][2 * (j % 2)] =
            pack_bf16(fmaxf(hc[m][j][0] + bb0, 0.f), fmaxf(hc[m][j][1] + bb1, 0.f));
        ha[m][j / 2][2 * (j % 2) + 1] =
            pack_bf16(fmaxf(hc[m][j][2] + bb0, 0.f), fmaxf(hc[m][j][3] + bb1, 0.f));
      }
    }
#pragma unroll
    for (int s = 0; s < HC / 16; ++s) {
#pragma unroll
      for (int jo = 0; jo < MAX_C / 8; jo += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, w2s + (8 * jo + lrow) * ldw2 + h0 + 16 * s + lcol);
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][jo], ha[m][s], b0);
          mma_bf16(acc[m][jo + 1], ha[m][s], b1);
        }
      }
    }
  }
}

// The same in f32 through 3xTF32, x split into xh + xl. The depth of every
// product is permuted: in a step of 8, logical k = t and t + 4 are physical
// 2t and 2t + 1, so A and B fragments are float2 reads and the accumulator
// of x @ W1 is the A fragment of h @ W2 as it stands.
template <int MT>
__device__ __forceinline__ void ff_fwd_products(const float* w1s, const float* w2s,
                                                const float* b1s, int hidden, int ldw2, int lane,
                                                const uint32_t (&xh)[MT][MAX_C / 8][4],
                                                const uint32_t (&xl)[MT][MAX_C / 8][4],
                                                float (&acc)[MT][MAX_C / 8][4]) {
  constexpr int ldw1 = MAX_C + PAD;
  const int g = lane / 4, t = lane % 4;
  for (int h0 = 0; h0 < hidden; h0 += HC) {
    float hc[MT][HC / 8][4];
    zero(hc);
#pragma unroll
    for (int kk = 0; kk < MAX_C / 8; ++kk) {
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const float2 v = ld_f2(w1s + (h0 + 8 * j + g) * ldw1 + kk * 8 + 2 * t);
        uint32_t bh[2], bl[2];
        split_tf32(v.x, bh[0], bl[0]);
        split_tf32(v.y, bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_3xtf32(hc[m][j], xh[m][kk], xl[m][kk], bh, bl);
      }
    }
    // h = relu(. + b1); n-tile s (columns h0 + 8s + 2t, +1 of rows g, g + 8)
    // is the A fragment of depth step s: a0, a1, a2, a3 = c0, c2, c1, c3.
#pragma unroll
    for (int s = 0; s < HC / 8; ++s) {
      const float bb0 = b1s[h0 + 8 * s + 2 * t], bb1 = b1s[h0 + 8 * s + 2 * t + 1];
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        split_tf32(fmaxf(hc[m][s][0] + bb0, 0.f), ah[m][0], al[m][0]);
        split_tf32(fmaxf(hc[m][s][2] + bb0, 0.f), ah[m][1], al[m][1]);
        split_tf32(fmaxf(hc[m][s][1] + bb1, 0.f), ah[m][2], al[m][2]);
        split_tf32(fmaxf(hc[m][s][3] + bb1, 0.f), ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int jo = 0; jo < MAX_C / 8; ++jo) {
        const float2 v = ld_f2(w2s + (8 * jo + g) * ldw2 + h0 + 8 * s + 2 * t);
        uint32_t bh[2], bl[2];
        split_tf32(v.x, bh[0], bl[0]);
        split_tf32(v.y, bh[1], bl[1]);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_3xtf32(acc[m][jo], ah[m], al[m], bh, bl);
      }
    }
  }
}

// out rows [row0, row0 + 16*MT) below `rows` = acc + b2, in out's type.
template <int MT, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][MAX_C / 8][4], const float* b2s,
                                           T* __restrict__ out, int64_t row0, int rows, int cout,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int64_t r0 = row0 + m * 16 + g;
#pragma unroll
    for (int jo = 0; jo < MAX_C / 8; ++jo) {
      if (jo * 8 >= cout) break;
      const int col = 8 * jo + 2 * t;
      const float bb0 = b2s[col], bb1 = b2s[col + 1];
      if (r0 < rows) store2(out + r0 * cout + col, acc[m][jo][0] + bb0, acc[m][jo][1] + bb1);
      if (r0 + 8 < rows)
        store2(out + (r0 + 8) * cout + col, acc[m][jo][2] + bb0, acc[m][jo][3] + bb1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * FwdShape<T>::warps, 1) ff_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int rows, int cin,
    int hidden, int cout, int w1_sc, int w1_sh, int w2_sh, int w2_so) {
  constexpr int NW = FwdShape<T>::warps, NTF = 32 * NW, MT = FwdShape<T>::m_tiles;
  constexpr int WR = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldx = MAX_C + PAD, ldw1 = MAX_C + PAD;
  const int hp = fwd_staged_hidden(hidden);              // hidden columns staged
  const int ldw2 = hp + PAD;
  T* xs_all = reinterpret_cast<T*>(smem_raw);           // [NW][WR][ldx]
  T* w1s = xs_all + (size_t)NW * WR * ldx;               // [hp][ldw1]: W1[c, h] at h*ldw1 + c
  T* w2s = w1s + (size_t)hp * ldw1;                      // [MAX_C][ldw2]: W2[h, o] at o*ldw2 + h
  float* b1s = reinterpret_cast<float*>(w2s + (size_t)MAX_C * ldw2);
  float* b2s = b1s + hp;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  T* xs = xs_all + (size_t)warp * WR * ldx;
  const int n_tiles = (rows + WR - 1) / WR;
  const int step = gridDim.x * NW;
  int tile = blockIdx.x + gridDim.x * warp;

  // Narrower shapes are zero-padded to C_in = C_out = MAX_C: the x and W1
  // columns past cin and the W2 rows past cout are zeros that no copy writes.
  const T t_zero = from_f<T>(0.f);
  for (int i = threadIdx.x; i < (NW * WR + hidden) * (MAX_C - cin); i += NTF) {
    const int r = i / (MAX_C - cin);
    (r < NW * WR ? xs_all + r * ldx : w1s + (r - NW * WR) * ldw1)[cin + i % (MAX_C - cin)] =
        t_zero;
  }
  for (int i = threadIdx.x; i < (MAX_C - cout) * hidden; i += NTF)
    w2s[(cout + i / hidden) * ldw2 + i % hidden] = t_zero;
  // The hidden columns past H, up to hp: zero W1 rows and W2 columns.
  for (int i = threadIdx.x; i < (hp - hidden) * MAX_C; i += NTF) {
    const int h = hidden + i / MAX_C, c = i % MAX_C;
    w1s[h * ldw1 + c] = t_zero;
    w2s[c * ldw2 + h] = t_zero;
  }
  stage_matrix(w1s, ldw1, w1, hidden, cin, w1_sh, w1_sc);
  stage_matrix(w2s, ldw2, w2, cout, hidden, w2_so, w2_sh);
  for (int i = threadIdx.x; i < hp; i += NTF) b1s[i] = i < hidden ? to_f(b1[i]) : 0.f;
  for (int i = threadIdx.x; i < cout; i += NTF) b2s[i] = to_f(b2[i]);
  if (tile < n_tiles) load_x_tile<T, WR>(xs, ldx, x, tile, rows, cin, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (; tile < n_tiles; tile += step) {
    float acc[MT][MAX_C / 8][4];
    zero(acc);
    if constexpr (std::is_same<T, float>::value) {
      uint32_t xh[MT][MAX_C / 8][4], xl[MT][MAX_C / 8][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int kk = 0; kk < MAX_C / 8; ++kk) {
          const float* p = xs + (m * 16 + g) * ldx + kk * 8 + 2 * t;
          const float2 v = ld_f2(p), w = ld_f2(p + 8 * ldx);
          split_tf32(v.x, xh[m][kk][0], xl[m][kk][0]);
          split_tf32(w.x, xh[m][kk][1], xl[m][kk][1]);
          split_tf32(v.y, xh[m][kk][2], xl[m][kk][2]);
          split_tf32(w.y, xh[m][kk][3], xl[m][kk][3]);
        }
      __syncwarp();
      if (tile + step < n_tiles) load_x_tile<T, WR>(xs, ldx, x, tile + step, rows, cin, lane);
      cp_async_commit();
      ff_fwd_products<MT>(w1s, w2s, b1s, hp, ldw2, lane, xh, xl, acc);
    } else {
      uint32_t xa[MT][MAX_C / 16][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int kk = 0; kk < MAX_C / 16; ++kk) {
          const T* p = xs + (m * 16 + g) * ldx + kk * 16 + 2 * t;
          xa[m][kk][0] = ld_u32(p);
          xa[m][kk][1] = ld_u32(p + 8 * ldx);
          xa[m][kk][2] = ld_u32(p + 8);
          xa[m][kk][3] = ld_u32(p + 8 * ldx + 8);
        }
      __syncwarp();
      if (tile + step < n_tiles) load_x_tile<T, WR>(xs, ldx, x, tile + step, rows, cin, lane);
      cp_async_commit();
      ff_fwd_products<MT>(w1s, w2s, b1s, hp, ldw2, lane, xa, acc);
    }
    store_tile<MT>(acc, b2s, out, (int64_t)tile * WR, rows, cout, lane);
    cp_async_wait_all();
    __syncwarp();
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
// sums (2*64*H + H + 64 floats, 129 KB in f32 at the flagship) fit neither
// in registers nor twice in one SM's shared memory. So the grid is
// persistent: one block per SM (the wrapper passes `blocks` = min(tiles,
// SMs)), each looping over 64-row tiles blockIdx.x, blockIdx.x + blocks, ...
// (that loop takes the place of the TPU's sequential grid) and holding its
// weight-gradient sums in shared memory, each sum owned by one thread, so no
// atomics are needed. A block walks the hidden dimension in chunks of 64 for
// every tile; dx of the tile stays in registers across the chunks. At the
// end each block writes its sums to an f32 partial row, and a second small
// kernel adds the rows in block order. The gradients are thus
// bit-identical from run to run on a given card. We chose "a block loops
// over row tiles" over "a block owns a slice of the hidden dimension"
// because dx sums over the whole hidden dimension: with the hidden dimension
// split across blocks, dx would need a second pass over a [rows, C_in] f32
// partial per slice, which is more traffic than x, g and dx together.
//
// Bound at the flagship (rows 77,824, C 64, H 256): 10*rows*C*H = 12.75 GFLOP
// and 59.8 MB in f32 (x and g in, dx out), so 0.077 ms in f32 done to f32
// accuracy on tensor cores (operations at 495/3 TFLOP/s); in bf16 0.0129 ms
// of operations against 0.0089 ms of bytes.
//
// Design. Each tile and chunk takes five 64x64x64 products on the staged
// tiles (x, g, the W1 and W2 chunks, h, dh), all on tensor cores through
// warp-level mma.sync: m16n8k16 bf16 with f32 sums, and in f32 3xTF32
// (m16n8k8, as in the forward kernel), which keeps f32 accuracy. Each of the
// 8 warps computes the same 16x32 piece (rows 16 (warp % 4), columns
// 32 (warp / 4)) of every 64x64 product, for every tile and chunk:
//   1. pre = x @ W1[:, chunk]      A = x [r][c],   B from W1^T [j][c]
//   2. gp  = g @ W2[chunk, :]^T    A = g [r][o],   B from W2^T [o][j] (transposed)
//   3. dx += dh @ W1[:, chunk]^T   A = dh [r][j],  B from W1^T [j][c] (transposed)
//   4. dW1[:, chunk] += x^T dh     A and B transposed: the depth is the rows
//   5. dW2[chunk, :] += h^T g      the same
// In bf16 the fragments come from ldmatrix (.trans where the depth runs
// down a staged tile's rows); in f32 they are scalar loads, split into TF32
// hi + lo as they are loaded. The f32 accumulator layout (lane holds rows g,
// g + 8 and columns 2t, 2t + 1 of each n-tile) fixes who owns what: pre and
// gp of one element meet in one thread, which forms h = relu(pre + b1) and
// dh and stores both rounded to x's type, as the JAX kernel rounds them,
// before any product or sum uses them (a no-op in f32); dx stays in
// registers across the chunks; and each weight-gradient sum is owned by the
// thread whose fragment holds it. The sums are kept in that fragment order
// (one float4 per lane and n-tile, so a warp's read-modify-write touches
// consecutive addresses) and put back in [C_in, H] / [H, C_out] order when
// a block writes its partial row. db1 and db2 are column sums of the staged
// dh and g tiles, four threads a column (add_column_sums); b1 sits in shared
// memory as f32.
// - The ReLU mask is decided in f32 where pre is near 0 (kMaskEps below).
// - Tiles are staged with 16-byte cp.async where rows are contiguous (x, g,
//   and the model's weight.t() views, whose inner stride is 1), else element
//   by element; everything past rows, C_in, C_out or H is staged as zeros,
//   so the products run over full 64-wide tiles and the padding adds zero.
// - Layouts, chosen so that every fragment read hits 32 distinct banks: bf16
//   rows are padded to 72 elements (144 bytes), which suits ldmatrix with or
//   without .trans; f32 rows are 64 floats with the column XOR-swizzled by
//   the row (BwdTile<float>), because the TF32 reads go both along and
//   across rows and no single row pad serves both, and because f32 has no
//   room for a pad beside the sums.
// Shapes: C_in <= 64, C_out <= 64, H a multiple of 16 (H_STEP, the forward
// kernel's rule; where H is not a multiple of 64 the last chunk is part
// filled, 16, 32 or 48 columns: its W1 and W2 tiles are staged with zeros
// past H (a 16-byte copy lies wholly inside or past H, since H is a multiple
// of 8 bf16 or 4 f32 values), every tile of every chunk is staged whole, so
// no row keeps an earlier tile's data, and the h, dh and sums of the columns
// past H are 0 (pre = 0 there, which the mask reads as off) and never written
// out: the warps' 16x32 pieces and frag_index map a whole 64-wide chunk
// whatever H is, and only the partial rows' loops, bounded by H, read them),
// and the shared memory of bwd_smem_bytes (six staged tiles and the sums of
// every 64-wide chunk of H: H <= 256 in f32 and <= 320 in bf16).
constexpr int BT = 64;  // tile edge: rows per tile, hidden chunk, C_in and C_out bound

// Element (r, c) of a staged 64x64 tile is at off(r, c). bf16: rows padded to
// 72 elements. f32: 64-float rows, column c stored at c ^ (8 (r % 4) + 4 (r / 4 % 2)),
// so that the reads (r0 + g, c0 + t) and (r0 + t, c0 + g) of a warp (g < 8,
// t < 4, r0 and c0 aligned) both fall on 32 distinct banks. The swizzle keeps
// aligned groups of 4 floats together, so 16-byte copies and float2 stores work.
template <typename T> struct BwdTile;
template <> struct BwdTile<float> {
  static constexpr int ld = BT;
  __device__ __forceinline__ static int off(int r, int c) {
    return r * BT + (c ^ (((r & 3) << 3) | (r & 4)));
  }
};
template <> struct BwdTile<__nv_bfloat16> {
  static constexpr int ld = BT + 8;
  __device__ __forceinline__ static int off(int r, int c) { return r * ld + c; }
};

// Floats of the weight-gradient sums for `chunks` 64-wide chunks of H: dW1
// and dW2 in fragment order (64 x 64 each per chunk), db1, db2.
__host__ __device__ __forceinline__ size_t bwd_sum_floats(int chunks) {
  return 2 * (size_t)chunks * BT * BT + (size_t)chunks * BT + BT;
}
// Shared memory of a backward block: six staged tiles, the sums, and b1 in f32.
template <typename T>
__host__ __device__ __forceinline__ size_t bwd_smem_bytes(int hidden) {
  const int chunks = (hidden + BT - 1) / BT;
  return 6 * (size_t)BT * BwdTile<T>::ld * sizeof(T) +
         sizeof(float) * (bwd_sum_floats(chunks) + (size_t)chunks * BT);
}

// The ReLU mask [pre > 0] is a step, so pre near 0 must have the sign that
// f32 arithmetic gives it, or dh gains or loses a whole g @ W2^T there. The
// tensor-core pre of an element differs from its f32 value by a small part
// of S = sum_c |x_c W1[c, j]|: 3xTF32 keeps about 2^-20 of each product, and
// the tensor cores' f32 sums truncate. Product 1 also forms S on the tensor
// cores (|x| @ |W1|, TF32 or bf16), and where |pre + b1| < 2^-15 S the
// thread recomputes pre on CUDA cores as one chain of f32 FMAs over
// c = 0, 1, ..., 63 (fma_chain), the order of a CUDA-core GEMM, which
// decides the mask (and h) as the plain version's matmul does. Few elements
// take that path, so it is a loop on a branch with one call site: calls
// inside the unrolled epilogue cost more than the rare recomputes.
constexpr float kMaskEps = 0x1p-15f;
// Floats of one block's partial row: dW1 [cin, hidden], db1, dW2 [hidden, cout], db2.
__host__ __device__ __forceinline__ int bwd_out_floats(int cin, int hidden, int cout) {
  return cin * hidden + hidden + hidden * cout + cout;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The 64x64 tile dst(r, c) = src[r * s_row + c * s_col] for r < n_rows and
// c < n_cols, zero elsewhere, by the whole block: 16-byte cp.async (zero-
// filling what lies outside) where rows are contiguous and aligned, else
// element by element along whichever index has stride 1 in src.
template <typename T>
__device__ void stage_tile(T* dst, const T* __restrict__ src, int64_t s_row, int64_t s_col,
                           int n_rows, int n_cols) {
  using L = BwdTile<T>;
  constexpr int V = 16 / sizeof(T);
  if (s_col == 1 && s_row % V == 0 && n_cols % V == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < BT * (BT / V); i += NT) {
      const int r = i / (BT / V), c = (i % (BT / V)) * V;
      const bool in = r < n_rows && c < n_cols;
      cp_async16(dst + L::off(r, c), in ? src + r * s_row + c : src, in ? 16 : 0);
    }
  } else {
    const bool rows_fast = s_row == 1;
    for (int i = threadIdx.x; i < BT * BT; i += NT) {
      const int r = rows_fast ? i % BT : i / BT, c = rows_fast ? i / BT : i % BT;
      dst[L::off(r, c)] = r < n_rows && c < n_cols ? src[r * s_row + c * s_col] : from_f<T>(0.f);
    }
  }
}

// acc[j] += A B over a depth of 64 for the warp's 16x32 piece at rows m0,
// columns n0 (n-tile j: columns n0 + 8j), in bf16: A(m, k) = a(m, k), or
// a(k, m) with AT; B(k, n) = b(n, k), or b(k, n) with BK; a and b staged tiles.
// With `sacc`, also sacc[j] += |A| |B|.
template <bool AT, bool BK>
__device__ __forceinline__ void warp_mm(const __nv_bfloat16* a, const __nv_bfloat16* b, int m0,
                                        int n0, int lane, float (&acc)[4][4],
                                        float (*sacc)[4] = nullptr) {
  using L = BwdTile<__nv_bfloat16>;
  const int i = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int k0 = 0; k0 < BT; k0 += 16) {
    uint32_t af[4];
    if (AT)
      ldmatrix_x4_trans(af, a + L::off(k0 + r8 + 8 * (i / 2), m0 + 8 * (i % 2)));
    else
      ldmatrix_x4(af, a + L::off(m0 + r8 + 8 * (i % 2), k0 + 8 * (i / 2)));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const int n = n0 + 16 * jp;
      uint32_t bf[4];
      if (BK)
        ldmatrix_x4_trans(bf, b + L::off(k0 + r8 + 8 * (i % 2), n + 8 * (i / 2)));
      else
        ldmatrix_x4(bf, b + L::off(n + r8 + 8 * (i / 2), k0 + 8 * (i % 2)));
      const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
      mma_bf16(acc[2 * jp], af, b0);
      mma_bf16(acc[2 * jp + 1], af, b1);
      if (sacc != nullptr) {
        constexpr uint32_t M = 0x7fff7fffu;  // |.| of two packed bf16
        const uint32_t aa[4] = {af[0] & M, af[1] & M, af[2] & M, af[3] & M};
        const uint32_t ba0[2] = {bf[0] & M, bf[1] & M}, ba1[2] = {bf[2] & M, bf[3] & M};
        mma_bf16(sacc[2 * jp], aa, ba0);
        mma_bf16(sacc[2 * jp + 1], aa, ba1);
      }
    }
  }
}

// The same in f32 through 3xTF32, each fragment element split as it is loaded.
// The thread's element of depth k = 8 kb + 4 e + t (kb = 4 kh + kl) lies
// - along a row (A as a(m, k), B as b(n, k)): in row R + g (R a multiple of
//   8, so its swizzle is g's) at 64 (R + g) + 32 kh + ((8 kl + 4 e + t) ^ swz(g));
// - down the rows (A as a(k, m), B as b(k, n)): in column C + 8 j + g (C a
//   multiple of 32) at 512 kb + 64 (4 e + t) + C + 8 (j ^ t) + (g ^ 4 e).
// So each address is one of 8 offsets of the thread, computed once, plus a
// constant of the unrolled loop.
template <bool AT, bool BK>
__device__ __forceinline__ void warp_mm(const float* a, const float* b, int m0, int n0, int lane,
                                        float (&acc)[4][4], float (*sacc)[4] = nullptr) {
  const int g = lane / 4, t = lane % 4;
  const int sg = ((g & 3) << 3) | (g & 4);
  // ao[kl][e] along rows m0 + g (+ 8 h), or ao[h][e] down the columns m0 + g + 8 h;
  // bo[kl][e] along rows n0 + g (+ 8 j), or bo[j][e] down the columns n0 + 8 j + g.
  int ao[4][2], bo[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int along = (8 * i + 4 * e + t) ^ sg, down = 64 * (4 * e + t) + (g ^ (4 * e));
      if (AT) {
        if (i < 2) ao[i][e] = down + (m0 & 32) + 8 * ((((m0 >> 4) & 1) * 2 + i) ^ t);
      } else {
        ao[i][e] = 64 * (m0 + g) + along;
      }
      bo[i][e] = BK ? down + n0 + 8 * (i ^ t) : 64 * (n0 + g) + along;
    }
  const auto A = [&](int h, int e, int kb) {
    return AT ? a[ao[h][e] + 512 * kb] : a[ao[kb % 4][e] + 512 * h + 32 * (kb / 4)];
  };
  const auto B = [&](int j, int e, int kb) {
    return BK ? b[bo[j][e] + 512 * kb] : b[bo[kb % 4][e] + 512 * j + 32 * (kb / 4)];
  };
#pragma unroll
  for (int kb = 0; kb < BT / 8; ++kb) {
    uint32_t ah[4], al[4];
    split_tf32(A(0, 0, kb), ah[0], al[0]);
    split_tf32(A(1, 0, kb), ah[1], al[1]);
    split_tf32(A(0, 1, kb), ah[2], al[2]);
    split_tf32(A(1, 1, kb), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh[2], bl[2];
      split_tf32(B(j, 0, kb), bh[0], bl[0]);
      split_tf32(B(j, 1, kb), bh[1], bl[1]);
      mma_3xtf32(acc[j], ah, al, bh, bl);
      if (sacc != nullptr) {  // one TF32 product of the |hi| parts
        constexpr uint32_t M = 0x7fffffffu;
        const uint32_t aa[4] = {ah[0] & M, ah[1] & M, ah[2] & M, ah[3] & M};
        const uint32_t ba[2] = {bh[0] & M, bh[1] & M};
        mma_tf32(sacc[j], aa, ba);
      }
    }
  }
}

// sum over c < 64 of x(r, c) W1^T(j, c) as one chain of f32 FMAs, c = 0, 1,
// ..., read 16 bytes at a time (the swizzle keeps aligned groups of 4 floats,
// and bf16 rows are 16-byte aligned).
__device__ __noinline__ float fma_chain(const float* xs, const float* w1t, int r, int j) {
  using L = BwdTile<float>;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < BT; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(xs + L::off(r, c));
    const float4 b = *reinterpret_cast<const float4*>(w1t + L::off(j, c));
    s = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
  }
  return s;
}
__device__ __noinline__ float fma_chain(const __nv_bfloat16* xs, const __nv_bfloat16* w1t, int r,
                                        int j) {
  using L = BwdTile<__nv_bfloat16>;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < BT; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(xs + L::off(r, c));
    const uint4 b = *reinterpret_cast<const uint4*>(w1t + L::off(j, c));
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[k]));
      const float2 w2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[k]));
      s = fmaf(x2.y, w2.y, fmaf(x2.x, w2.x, s));
    }
  }
  return s;
}

// s[col] += sum over the 64 rows of tile(r, col), for col < n, by the whole
// block: four threads a column, each over rows q, q + 4, ... (q = tid % 4,
// which puts a warp's reads on distinct banks), added up by shuffles.
template <typename T>
__device__ __forceinline__ void add_column_sums(float* s, const T* tile, int n) {
  static_assert(NT == 4 * BT, "four threads a column");
  using L = BwdTile<T>;
  const int col = threadIdx.x / 4, q = threadIdx.x % 4;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < BT / 4; ++i) v += to_f(tile[L::off(4 * i + q, col)]);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if (q == 0 && col < n) s[col] += v;
}

// Position of entry (m, n) of chunk q's 64x64 weight-gradient sum in fragment
// order: the warp whose piece holds it, its n-tile, the lane and the element.
__device__ __forceinline__ int frag_index(int q, int m, int n) {
  const int warp = m / 16 + 4 * (n / 32), j = n % 32 / 8;
  const int lane = 4 * (m % 8) + n % 8 / 2, e = 2 * (m % 16 / 8) + n % 2;
  return q * BT * BT + (((warp * 4 + j) * 32 + lane) * 4 + e);
}

// s += acc for the warp's piece of one chunk's sum, in fragment order.
__device__ __forceinline__ void add_piece(float* s, int warp, int lane, const float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4* p = reinterpret_cast<float4*>(s + ((warp * 4 + j) * 32 + lane) * 4);
    float4 v = *p;
    v.x += acc[j][0], v.y += acc[j][1], v.z += acc[j][2], v.w += acc[j][3];
    *p = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1) ff_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2, T* __restrict__ dx,
    float* __restrict__ partial, int rows, int cin, int hidden, int cout, int w1_sc, int w1_sh,
    int w2_sh, int w2_so) {
  using L = BwdTile<T>;
  constexpr int TE = BT * L::ld;  // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [row][c]
  T* gs = xs + TE;                          // [row][o]
  T* w1t = gs + TE;                         // [j][c]: W1[c, h0 + j]
  T* w2t = w1t + TE;                        // [o][j]: W2[h0 + j, o]
  T* hs = w2t + TE;                         // [row][j]
  T* dhs = hs + TE;                         // [row][j]
  const int chunks = (hidden + BT - 1) / BT;
  float* sums = reinterpret_cast<float*>(dhs + TE);
  float* s_w1 = sums;                                 // dW1 per chunk, fragment order
  float* s_w2 = s_w1 + (size_t)chunks * BT * BT;      // dW2 per chunk, fragment order
  float* s_b1 = s_w2 + (size_t)chunks * BT * BT;      // [chunks * 64]
  float* s_b2 = s_b1 + chunks * BT;                   // [64]
  float* b1s = s_b2 + BT;                             // [chunks * 64]: b1, zero-padded
  const int n_sums = (int)bwd_sum_floats(chunks);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gl = lane / 4, tl = lane % 4;
  const int m0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
  for (int i = tid; i < n_sums; i += NT) sums[i] = 0.f;
  for (int i = tid; i < chunks * BT; i += NT) b1s[i] = i < hidden ? to_f(b1[i]) : 0.f;

  const int n_tiles = (rows + BT - 1) / BT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * BT;
    const int n_rows = rows - row0 < BT ? (int)(rows - row0) : BT;
    __syncthreads();  // the sums are zeroed; the last tile's tiles are consumed
    stage_tile(xs, x + row0 * cin, cin, 1, n_rows, cin);
    stage_tile(gs, g + row0 * cout, cout, 1, n_rows, cout);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    add_column_sums(s_b2, gs, cout);

    float dxa[4][4];
    zero(dxa);
    for (int q = 0; q < chunks; ++q) {
      const int h0 = q * BT, n_h = min(BT, hidden - h0);
      __syncthreads();  // the last chunk's W1, W2, h and dh tiles are consumed
      stage_tile(w1t, w1 + (int64_t)h0 * w1_sh, w1_sh, w1_sc, n_h, cin);
      stage_tile(w2t, w2 + (int64_t)h0 * w2_sh, w2_so, w2_sh, cout, n_h);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();

      float pre[4][4], gp[4][4], mag[4][4];
      zero(pre);
      zero(gp);
      zero(mag);
      warp_mm<false, false>(xs, w1t, m0, n0, lane, pre, mag);  // x @ W1, |x| @ |W1|
      warp_mm<false, true>(gs, w2t, m0, n0, lane, gp);         // g @ W2^T
#pragma unroll
      // pre += b1; the elements within 2^-15 S of 0 again on CUDA cores (one
      // call site, on a branch that is rarely taken).
      unsigned need = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pre[j][e] += b1s[h0 + n0 + 8 * j + 2 * tl + e % 2];
          if (fabsf(pre[j][e]) < kMaskEps * mag[j][e]) need |= 1u << (4 * j + e);
        }
      while (need) {
        const int k = __ffs(need) - 1, e = k % 4;
        const int col = n0 + 8 * (k / 4) + 2 * tl + e % 2;
        need &= need - 1;
        const float v = fma_chain(xs, w1t, m0 + gl + 8 * (e / 2), col) + b1s[h0 + col];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (i == k) pre[i / 4][i % 4] = v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 8 * j + 2 * tl;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + gl + 8 * half;
          const float p0 = pre[j][2 * half], p1 = pre[j][2 * half + 1];
          store2(hs + L::off(r, col), fmaxf(p0, 0.f), fmaxf(p1, 0.f));
          store2(dhs + L::off(r, col), p0 > 0.f ? gp[j][2 * half] : 0.f,
                 p1 > 0.f ? gp[j][2 * half + 1] : 0.f);
        }
      }
      __syncthreads();

      warp_mm<false, true>(dhs, w1t, m0, n0, lane, dxa);  // dx += dh @ W1^T
      float t[4][4];
      zero(t);
      warp_mm<true, true>(xs, dhs, m0, n0, lane, t);  // x^T dh: rows c, columns j
      add_piece(s_w1 + (size_t)q * BT * BT, warp, lane, t);
      zero(t);
      warp_mm<true, true>(hs, gs, m0, n0, lane, t);  // h^T g: rows j, columns o
      add_piece(s_w2 + (size_t)q * BT * BT, warp, lane, t);
      add_column_sums(s_b1 + h0, dhs, n_h);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 8 * j + 2 * tl;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t gr = row0 + m0 + gl + 8 * half;
        if (gr >= rows) continue;
        T* p = dx + gr * cin + col;
        if (cin % 2 == 0) {
          if (col < cin) store2(p, dxa[j][2 * half], dxa[j][2 * half + 1]);
        } else {
          if (col < cin) p[0] = from_f<T>(dxa[j][2 * half]);
          if (col + 1 < cin) p[1] = from_f<T>(dxa[j][2 * half + 1]);
        }
      }
    }
  }
  __syncthreads();
  // The partial row in output order: dW1 [cin, hidden], db1, dW2 [hidden, cout], db2.
  float* dst = partial + (int64_t)blockIdx.x * bwd_out_floats(cin, hidden, cout);
  const int n_w1 = cin * hidden, n_w2 = hidden * cout;
  for (int i = tid; i < n_w1; i += NT) {
    const int c = i / hidden, h = i % hidden;
    dst[i] = s_w1[frag_index(h / BT, c, h % BT)];
  }
  for (int i = tid; i < hidden; i += NT) dst[n_w1 + i] = s_b1[i];
  for (int i = tid; i < n_w2; i += NT) {
    const int h = i / cout, o = i % cout;
    dst[n_w1 + hidden + i] = s_w2[frag_index(h / BT, h % BT, o)];
  }
  for (int i = tid; i < cout; i += NT) dst[n_w1 + hidden + n_w2 + i] = s_b2[i];
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
  const size_t smem = bwd_smem_bytes<T>(hidden);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ff_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ff_bwd_kernel<T><<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<T*>(dx), partial, rows,
      cin, hidden, cout, w1_sc, w1_sh, w2_sh, w2_so);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = bwd_out_floats(cin, hidden, cout);
  ff_bwd_reduce_kernel<<<(n + NT - 1) / NT, NT, 0, stream>>>(partial, blocks, n, out);
  return cudaGetLastError();
}

// Blocks of the persistent forward grid for `smem` bytes a block on the
// current device: as many as fit on the card at once. The shared-memory
// attribute and the occupancy are set and asked once per device and size.
template <typename T>
cudaError_t fwd_grid_limit(size_t smem, int* limit) {
  static int cached_dev = -1, cached_limit = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(ff_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ff_fwd_kernel<T>,
                                                          32 * FwdShape<T>::warps, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev;
    cached_smem = smem;
    cached_limit = sms * per_sm;
  }
  *limit = cached_limit;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int rows, int cin, int hidden, int cout,
                   int w1_sc, int w1_sh, int w2_sh, int w2_so, cudaStream_t stream) {
  constexpr int NW = FwdShape<T>::warps, WR = 16 * FwdShape<T>::m_tiles;
  const size_t smem = fwd_smem_bytes<T>(hidden, cout);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = fwd_grid_limit<T>(smem, &limit);
  if (err != cudaSuccess) return err;
  const int warp_tiles = (rows + WR - 1) / WR;
  const int blocks = min((warp_tiles + NW - 1) / NW, limit);
  ff_fwd_kernel<T><<<blocks, 32 * NW, smem, stream>>>(
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
  if (rows <= 0 || cin <= 0 || cin > MAX_C || cin % 16 || hidden <= 0 || hidden % H_STEP ||
      cout <= 0 || cout > MAX_C || cout % 8 || (reinterpret_cast<uintptr_t>(x) & 15))
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

// Shared memory bytes one forward block needs (dtype as in ff_fwd).
extern "C" long long ff_fwd_smem_bytes(int dtype, int hidden, int cout) {
  return dtype == 0 ? (long long)fwd_smem_bytes<float>(hidden, cout)
                    : (long long)fwd_smem_bytes<__nv_bfloat16>(hidden, cout);
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
  if (rows <= 0 || cin <= 0 || cin > BT || hidden <= 0 || hidden % H_STEP || cout <= 0 ||
      cout > BT || blocks <= 0 || blocks > (rows + BT - 1) / BT)
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

// Shared memory bytes one backward block needs (dtype as in ff_bwd).
extern "C" long long ff_bwd_smem_bytes(int dtype, int hidden) {
  return dtype == 0 ? (long long)bwd_smem_bytes<float>(hidden)
                    : (long long)bwd_smem_bytes<__nv_bfloat16>(hidden);
}
