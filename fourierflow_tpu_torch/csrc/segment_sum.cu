// Segment sum: out[n, f] = the sum over the rows e of segment n, in ascending
// e, of values[e, f], starting from 0 (segment_sum below).
//
// Replaces no TPU kernel. The JAX package scatters MeshGraphNet's edge
// messages onto their receiving nodes with `.at[r_idx].add`
// (fourierflow_tpu/models/meshgraphnet.py:108), which XLA computes, and the
// gathers' gradients are the same scatter. PyTorch's index_add_ sums with
// float atomics on the card, in an order that changes from run to run, so
// two fits of one seed differ. This kernel sums each segment in one thread,
// row after row in ascending order: the order of the CPU's index_add_ into
// zeros, so it gives the CPU's bits, and the same bits on every run.
//
// The caller sorts the segment index once, stably (ops/segment.py::
// segment_csr): `order` lists the rows of segment 0, then of segment 1, ...,
// each segment's rows ascending, and segment n's rows are order[offsets[n]]
// to order[offsets[n + 1] - 1]. A row whose index is negative belongs to no
// segment (it sorts before offsets[0]) and is not read.
//
// What bounds it: bytes. One add per value read; each row of a segment is
// read once (E_used x F floats), out written once (N x F), and order and
// offsets once. At cylinder_flow/baseline (batch 4 of meshes of up to 1,920
// nodes and 21,996 edge slots, about 11,000 of them used; latent F 128) that
// is about 26 MB, 8 us at 3.35 TB/s.
//
// Design: one thread per (segment, feature), the feature fastest, so the 32
// threads of a warp read 128 consecutive bytes of one row and share that
// row's order entry. Every thread of a segment walks the same rows, so a
// warp does not diverge; the rows' loads do not depend on the sum, so they
// run ahead of it. A segment is a node's incoming (or outgoing) edges: a
// handful of rows on a triangle mesh.
//
// Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

__global__ void __launch_bounds__(NT) segment_sum_kernel(const float* __restrict__ values,
                                                         const int64_t* __restrict__ order,
                                                         const int64_t* __restrict__ offsets,
                                                         float* __restrict__ out, int64_t n,
                                                         int f) {
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= n * f) return;
  const int64_t seg = i / f;
  const int c = (int)(i - seg * f);
  const int64_t end = offsets[seg + 1];
  float s = 0.f;
#pragma unroll 4
  for (int64_t k = offsets[seg]; k < end; ++k) s += values[order[k] * f + c];
  out[i] = s;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// values [rows, f] float32, order [rows] and offsets [n + 1] int64 (as above),
// out [n, f] float32, all contiguous. Returns a cudaError_t (0 on success).
extern "C" int segment_sum(const void* values, const void* order, const void* offsets, void* out,
                           long long n, int f, void* stream) {
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n * f + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(offsets), static_cast<float*>(out), n, f);
  return (int)cudaGetLastError();
}
