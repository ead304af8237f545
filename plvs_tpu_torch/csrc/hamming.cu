// All-pairs Hamming distance of packed 256-bit binary descriptors.
//
// Replaces the TPU kernel plvs_tpu/ops/hamming.py::hamming_pallas
// (_hamming_kernel_mxu: +-1 bf16 unpack and one MXU dot per 128x128 tile;
// _hamming_kernel_vpu: XOR + SWAR popcount) and the dispatch that feeds it,
// hamming_matrix.
//
// What bounds it on an H100: the [Q, K] int32 output. Inputs are 32 B per
// descriptor (Q*32 + K*32 bytes), the output is 4*Q*K bytes; at the main
// path's 4096 x 1024 the 16.8 MB write alone takes >= 5.0 us at 3.35 TB/s,
// while the arithmetic (8 XOR + 8 popc + 7 adds per output, integer ALU)
// is ~0.2 us of the card's integer rate. So the design is a plain tiled
// kernel whose only job is to stream the output at full width:
//   * one block per 64 x 64 output tile, 256 threads;
//   * the block stages its 64 query rows and 64 key rows (2 KB each) in
//     shared memory once;
//   * thread t owns output column (t % 64) and keeps that key's 8 words in
//     registers; it walks rows (t / 64) + 4*i, reading the query words as
//     shared-memory broadcasts, so each warp stores 32 consecutive int32
//     (one 128 B transaction) per row;
//   * ragged edges are masked; padding rows are never read.
// Exact: popcount of XOR is integer arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int WORDS = 8;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / TILE;  // 4 rows in flight per pass

__global__ void hamming_kernel(const uint32_t* __restrict__ dq,
                               const uint32_t* __restrict__ dk,
                               int32_t* __restrict__ out, int q, int k) {
  __shared__ uint32_t sq[TILE][WORDS + 1];  // +1: no bank conflicts on fill
  __shared__ uint32_t sk[TILE][WORDS + 1];
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;

  for (int i = tid; i < TILE * WORDS; i += THREADS) {
    const int r = i / WORDS, w = i % WORDS;
    sq[r][w] = (row0 + r < q) ? dq[(int64_t)(row0 + r) * WORDS + w] : 0u;
    sk[r][w] = (col0 + r < k) ? dk[(int64_t)(col0 + r) * WORDS + w] : 0u;
  }
  __syncthreads();

  const int c = tid % TILE;
  const int col = col0 + c;
  if (col >= k) return;
  uint32_t kw[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) kw[w] = sk[c][w];

  for (int r = tid / TILE; r < TILE; r += ROW_STEP) {
    const int row = row0 + r;
    if (row >= q) break;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) acc += __popc(sq[r][w] ^ kw[w]);
    out[(int64_t)row * k + col] = acc;
  }
}

}  // namespace

extern "C" int plvs_hamming(const void* dq, const void* dk, void* out, int q,
                            int k, void* stream) {
  if (q <= 0 || k <= 0) return 0;
  const dim3 grid((k + TILE - 1) / TILE, (q + TILE - 1) / TILE);
  hamming_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dq), static_cast<const uint32_t*>(dk),
      static_cast<int32_t*>(out), q, k);
  return static_cast<int>(cudaGetLastError());
}
