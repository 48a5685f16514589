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
// Shapes: C_in a multiple of 16 and <= 64, H a multiple of 64, C_out a
// multiple of 8 and <= 64, and the shared memory of fwd_smem_bytes. x (16-
// byte aligned), biases and out are contiguous; W1 [C_in, H] and W2
// [H, C_out] are read through element strides.
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
constexpr int HC = 64;           // hidden columns per chunk
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

template <typename T>
__host__ __device__ __forceinline__ size_t fwd_smem_bytes(int hidden, int cout) {
  const size_t elems =
      (size_t)FwdShape<T>::warps * 16 * FwdShape<T>::m_tiles * (MAX_C + PAD) +
      (size_t)hidden * (MAX_C + PAD) + (size_t)MAX_C * (hidden + PAD);
  return elems * sizeof(T) + sizeof(float) * (size_t)(hidden + cout);
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
  const int ldw2 = hidden + PAD;
  T* xs_all = reinterpret_cast<T*>(smem_raw);           // [NW][WR][ldx]
  T* w1s = xs_all + (size_t)NW * WR * ldx;               // [hidden][ldw1]: W1[c, h] at h*ldw1 + c
  T* w2s = w1s + (size_t)hidden * ldw1;                  // [MAX_C][ldw2]: W2[h, o] at o*ldw2 + h
  float* b1s = reinterpret_cast<float*>(w2s + (size_t)MAX_C * ldw2);
  float* b2s = b1s + hidden;

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
  stage_matrix(w1s, ldw1, w1, hidden, cin, w1_sh, w1_sc);
  stage_matrix(w2s, ldw2, w2, cout, hidden, w2_so, w2_sh);
  for (int i = threadIdx.x; i < hidden; i += NTF) b1s[i] = to_f(b1[i]);
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
      ff_fwd_products<MT>(w1s, w2s, b1s, hidden, ldw2, lane, xh, xl, acc);
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
      ff_fwd_products<MT>(w1s, w2s, b1s, hidden, ldw2, lane, xa, acc);
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
// sums (C_in*H + H*C_out floats, 128 KB in f32 at the flagship) fit neither
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
// of operations against 0.0089 ms of bytes. This version computes five
// 64x64x64 products per tile and chunk on CUDA cores in f32 (4x4 outputs per
// thread); tensor cores are later work. As the JAX kernel does, h and dh are
// rounded to x's type where they are stored to shared memory, before any
// product or sum uses them (a no-op in f32). Shared memory: six padded 64x64
// f32 tiles (x, g, W1 and W2 chunks, h, dh) and the sums, 232,192 bytes at
// the flagship, so C_in <= 64, C_out <= 64 and H <= 256 at C = 64 (the
// wrapper checks the size). Rows beyond `rows` are staged as zeros, so g = 0
// there and they add nothing.
constexpr int TX = 16;           // threads along columns
constexpr int TY = 16;           // threads along rows
constexpr int TD = 64;           // tile edge: rows per tile, hidden chunk, C_in and C_out bound
constexpr int LD = TD + 1;       // padded row length of the staged tiles
constexpr int NQ = TD / TX;      // output columns per thread (4)
constexpr int RT = TD / TY;      // rows per thread (4)

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
          hs[(ty * RT + r) * LD + j] = to_f(from_f<T>(fmaxf(p, 0.f)));
          dhs[(ty * RT + r) * LD + j] = to_f(from_f<T>(p > 0.f ? gp[r][q] : 0.f));
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
  if (rows <= 0 || cin <= 0 || cin > MAX_C || cin % 16 || hidden <= 0 || hidden % HC ||
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
