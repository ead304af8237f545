// All-pairs Hamming distance of packed 256-bit binary descriptors (K1).
//
// Replaces the TPU kernel plvs_tpu/ops/hamming.py::hamming_pallas
// (_hamming_kernel_mxu: +-1 bf16 unpack and one MXU dot per 128x128 tile;
// _hamming_kernel_vpu: XOR + SWAR popcount) and the dispatch that feeds it,
// hamming_matrix.
//
// Bound on an H100: the [Q, K] int32 output. Inputs are 32 B a descriptor,
// the output 4 B a pair; at the main path's 4096 x 1024 the 16.8 MB write
// takes >= 5.06 us at 3.35 TB/s.
//
// What held the first design back (one thread an output column, 8 POPC of
// XOR an output on the CUDA cores, one 4-B store an output): at 4096 x 1024
// it took 11.8 us; a copy with the POPC replaced by a shift took 9.8 us,
// and a zero_ of the output 5.9 us (scripts/probe_k1_design.py, H100 SXM,
// PERF.md). POPC issues at a quarter of the rate of XOR or add on compute
// capability 9.0 and cost 2 us; the per-output scalar work and narrow
// stores cost the other 4 us over the write.
//
// This design moves the popcount onto the tensor cores, as the TPU kernel
// moved it onto the MXU, and makes the store path the design:
//   * one 1-bit tensor-core product per 16 x 8 output fragment,
//     mma.sync.m16n8k256 .b1 .and.popc (SASS BMMA.168256.AND.POPC): k = 256
//     is exactly one descriptor, so the A and B fragments are the packed
//     words as they lie in memory (lane (g, t) holds words t and t + 4 of
//     rows g and g + 8), no unpack;
//   * H(a, b) = pop(a) + pop(b) - 2 popc(a & b), each row's popcount taken
//     once per fragment and summed across its 4 lanes by shuffles;
//   * each warp owns a 16 x 32 output tile: it stages it in shared memory
//     (pitch 40 words: the 8-B fragment writes are conflict-free) and
//     writes it back as whole 128-B lines, one 16-B store a lane, with the
//     default cache policy (the matcher reads the matrix at once, and it
//     fits the 50 MB L2); a K that is not a multiple of 4, or a ragged
//     edge, stores word by word;
//   * warps share nothing, so a block (four warps side by side, a 16 x 128
//     tile) is only a scheduling unit: held to 32 registers a thread, with
//     11 KB of shared memory a block, 16 blocks are resident a SM, so
//     4096 x 1024 (2048 blocks) runs in one wave, and the small line
//     searches get one block per 16 rows.
// Exact: integer arithmetic only.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WORDS = 8;
constexpr int WARPS = 4;                  // a block: 16 x (WARPS * COLS)
constexpr int FRAGS = 4;                  // 16 x 8 fragments a warp
constexpr int COLS = 8 * FRAGS;           // a warp's tile width, int32
constexpr int PITCH = COLS + 8;           // staging row pitch, int32
constexpr int LANES_PER_ROW = COLS / 4;   // one 16-B store a lane
constexpr int ROWS_PER_STORE = 32 / LANES_PER_ROW;
constexpr unsigned FULL = 0xffffffffu;
static_assert(COLS == 32, "one 128-B line a row");

// d += popc(a & b) over k = 256 for one 16 x 8 fragment
__device__ __forceinline__ void bmma_and_popc(int (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* d, int row,
                                                 int n, int w) {
  return row < n ? __ldg(d + (int64_t)row * WORDS + w) : 0u;
}

// popcount of the descriptor whose words t and t + 4 this lane holds,
// summed over the 4 lanes that hold the rest of it
__device__ __forceinline__ int row_pop(uint32_t lo, uint32_t hi) {
  int p = __popc(lo) + __popc(hi);
  p += __shfl_xor_sync(FULL, p, 1);
  p += __shfl_xor_sync(FULL, p, 2);
  return p;
}

__global__ void __launch_bounds__(32 * WARPS, 16)
hamming_bmma_kernel(const uint32_t* __restrict__ dq,
                    const uint32_t* __restrict__ dk,
                    int32_t* __restrict__ out, int q, int k, int vec) {
  __shared__ __align__(16) int32_t stage[WARPS][16 * PITCH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.y * 16;
  const int col0 = (blockIdx.x * WARPS + warp) * COLS;
  if (col0 >= k) return;  // warp-uniform: no block barriers

  uint32_t a[4], b[FRAGS][2];
  a[0] = word_or_zero(dq, row0 + g, q, t);
  a[1] = word_or_zero(dq, row0 + g + 8, q, t);
  a[2] = word_or_zero(dq, row0 + g, q, t + 4);
  a[3] = word_or_zero(dq, row0 + g + 8, q, t + 4);
#pragma unroll
  for (int n = 0; n < FRAGS; ++n) {
    b[n][0] = word_or_zero(dk, col0 + 8 * n + g, k, t);
    b[n][1] = word_or_zero(dk, col0 + 8 * n + g, k, t + 4);
  }
  const int pa_top = row_pop(a[0], a[2]);  // query row g
  const int pa_bot = row_pop(a[1], a[3]);  // query row g + 8

  int32_t* st = stage[warp];
#pragma unroll
  for (int n = 0; n < FRAGS; ++n) {
    const int p = row_pop(b[n][0], b[n][1]);     // key g, in every lane of g
    const int pb0 = __shfl_sync(FULL, p, 8 * t);      // key 2t
    const int pb1 = __shfl_sync(FULL, p, 8 * t + 4);  // key 2t + 1
    int acc[4] = {0, 0, 0, 0};
    bmma_and_popc(acc, a, b[n]);
    *reinterpret_cast<int2*>(st + g * PITCH + 8 * n + 2 * t) =
        make_int2(pa_top + pb0 - 2 * acc[0], pa_top + pb1 - 2 * acc[1]);
    *reinterpret_cast<int2*>(st + (g + 8) * PITCH + 8 * n + 2 * t) =
        make_int2(pa_bot + pb0 - 2 * acc[2], pa_bot + pb1 - 2 * acc[3]);
  }
  __syncwarp();

  const int c4 = 4 * (lane % LANES_PER_ROW);
  const int col = col0 + c4;
  if (col >= k) return;
#pragma unroll
  for (int r = lane / LANES_PER_ROW; r < 16; r += ROWS_PER_STORE) {
    const int row = row0 + r;
    if (row >= q) break;
    const int4 v = *reinterpret_cast<const int4*>(st + r * PITCH + c4);
    int32_t* dst = out + (int64_t)row * k + col;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (col + 1 < k) dst[1] = v.y;
      if (col + 2 < k) dst[2] = v.z;
      if (col + 3 < k) dst[3] = v.w;
    }
  }
}

}  // namespace

extern "C" int plvs_hamming(const void* dq, const void* dk, void* out, int q,
                            int k, void* stream) {
  if (q <= 0 || k <= 0) return 0;
  const int block_cols = WARPS * COLS;
  const dim3 grid((k + block_cols - 1) / block_cols, (q + 15) / 16);
  // 16-B stores need every row to start on a 16-B boundary
  const int vec = (k % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  hamming_bmma_kernel<<<grid, 32 * WARPS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dq), static_cast<const uint32_t*>(dk),
      static_cast<int32_t*>(out), q, k, vec);
  return static_cast<int>(cudaGetLastError());
}
