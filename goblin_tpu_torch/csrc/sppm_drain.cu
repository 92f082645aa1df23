// SPPM's drain in pair form, integrators/sppm.py::drain_pairs on CUDA
// tensors: the match of each visible point against its grid cell's photon
// entries, and the ordered sum of the matches' contributions.
//
// It replaces no Pallas kernel. goblin_tpu/integrators/sppm.py::vp_drain is
// a jax.lax.while_loop over the fullest cell's entries, each turn over every
// visible point, and the port ran it as such: ~60 turns of ~46 PyTorch
// operations a drain over 196,608 points, to examine ~128,000 candidate
// (point, entry) pairs of which ~17,000 pass. Here three kernels take the
// loop's place around one BSDF evaluation in PyTorch over the passing pairs
// (bsdf_eval stays the one source of every material's BSDF):
//
// - match, count pass: one thread a visible point walks its cell's entries
//   start .. end in order and applies the turn loop's test, the distance
//   (dp - p) . (dp - p) <= r2 and the path length plen <= budget; it writes
//   the number that pass;
// - match, fill pass (after a cumsum of the counts on the host's stream and
//   the drain's one read of the pair total): the same walk, writing each
//   passing entry's row and its point at the point's offset, in turn order;
// - sum: one thread a visible point adds its pairs' contributions into Phi
//   and 1 a pair into M, in pair order, which is the turn loop's order.
//
// Bit-equality with the turn loop: every float operation rounds as
// PyTorch's separate elementwise kernels do, __fsub_rn / __fmul_rn /
// __fadd_rn in vecmath.dot's order ((dx dx + dy dy) + dz dz), and the build
// has --fmad=false besides. The loop adds 0.0 for a turn that fails, which
// leaves a sum unchanged (Phi starts at +0.0 and never becomes -0.0), so
// skipping those turns is exact.
//
// What bounds it on this card (NVIDIA H100): bytes, and those few. A count
// pass at 196,608 points reads 36 B a point (start, end, p, r2, budget), 4 B
// a candidate entry and 16 B of each row it touches, and writes 4 B a point:
// ~10 MB, 3 us at 3.35 TB/s; the sum reads 12 B a pair and 28 B a point and
// writes 16 B a point. Each pass is one launch a drain, so the launch and
// the walks' dependent loads set its time. A thread walks entries that its
// neighbours (the next pixels) mostly share, so the rows come from cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// a launch's most blocks: 8 resident blocks on each of 132 SMs; larger
// calls loop
constexpr int64_t kMaxBlocks = 132 * 8;
// a deposit row: p (3), wi (3), wgt (3), path length (1)
constexpr int kRowFloats = 10;
constexpr int kPlen = 9;

unsigned blocks_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// kFill false: counts[i] <- the entries of point i's cell that pass.
// kFill true: pair_row / pair_point from ends[i] - counts[i] on, in order.
template <bool kFill>
__global__ void __launch_bounds__(kThreads)
    match_kernel(int64_t n, const int64_t* __restrict__ start,
                 const int64_t* __restrict__ end,
                 const int32_t* __restrict__ entry_idx,
                 const float* __restrict__ rows, const float* __restrict__ p,
                 const float* __restrict__ r2,
                 const float* __restrict__ budget, int32_t* __restrict__ counts,
                 const int64_t* __restrict__ ends,
                 int64_t* __restrict__ pair_row,
                 int64_t* __restrict__ pair_point) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
    const float r2_i = r2[i], budget_i = budget[i];
    int64_t out = 0;
    if (kFill) out = ends[i] - counts[i];
    int32_t passed = 0;
    const int64_t e = end[i];
    for (int64_t k = start[i]; k < e; ++k) {
      const int32_t row = entry_idx[k];
      const float* q = rows + static_cast<int64_t>(row) * kRowFloats;
      const float dx = __fsub_rn(q[0], px);
      const float dy = __fsub_rn(q[1], py);
      const float dz = __fsub_rn(q[2], pz);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 <= r2_i && q[kPlen] <= budget_i) {
        if (kFill) {
          pair_row[out + passed] = row;
          pair_point[out + passed] = i;
        }
        ++passed;
      }
    }
    if (!kFill) counts[i] = passed;
  }
}

// phi_out / mi_out <- phi / mi plus point i's pairs' contributions and 1 a
// pair, added one at a time in pair order.
__global__ void __launch_bounds__(kThreads)
    sum_kernel(int64_t n, const int32_t* __restrict__ counts,
               const int64_t* __restrict__ ends,
               const float* __restrict__ contrib,
               const float* __restrict__ phi, const float* __restrict__ mi,
               float* __restrict__ phi_out, float* __restrict__ mi_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float x = phi[3 * i], y = phi[3 * i + 1], z = phi[3 * i + 2];
    float m = mi[i];
    const int64_t last = ends[i];
    for (int64_t j = last - counts[i]; j < last; ++j) {
      x = __fadd_rn(x, contrib[3 * j]);
      y = __fadd_rn(y, contrib[3 * j + 1]);
      z = __fadd_rn(z, contrib[3 * j + 2]);
      m = __fadd_rn(m, 1.0f);
    }
    phi_out[3 * i] = x;
    phi_out[3 * i + 1] = y;
    phi_out[3 * i + 2] = z;
    mi_out[i] = m;
  }
}

}  // namespace

// The count pass: counts (n,) int32. start / end (n,) int64 index the
// sorted entries' entry_idx (int32 rows of rows, (N, 10) float32); p (n, 3),
// r2 and budget (n,) float32. Launched on `stream`; returns
// cudaGetLastError().
extern "C" int goblin_sppm_drain_count(int64_t n, const void* start,
                                       const void* end, const void* entry_idx,
                                       const void* rows, const void* p,
                                       const void* r2, const void* budget,
                                       void* counts, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  match_kernel<false><<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int64_t*>(start), static_cast<const int64_t*>(end),
      static_cast<const int32_t*>(entry_idx), static_cast<const float*>(rows),
      static_cast<const float*>(p), static_cast<const float*>(r2),
      static_cast<const float*>(budget), static_cast<int32_t*>(counts),
      nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The fill pass: the count pass's inputs, its counts and their inclusive
// cumsum ends (n,) int64 -> pair_row, pair_point (ends[n - 1],) int64.
extern "C" int goblin_sppm_drain_fill(int64_t n, const void* start,
                                      const void* end, const void* entry_idx,
                                      const void* rows, const void* p,
                                      const void* r2, const void* budget,
                                      const void* counts, const void* ends,
                                      void* pair_row, void* pair_point,
                                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  match_kernel<true><<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int64_t*>(start), static_cast<const int64_t*>(end),
      static_cast<const int32_t*>(entry_idx), static_cast<const float*>(rows),
      static_cast<const float*>(p), static_cast<const float*>(r2),
      static_cast<const float*>(budget),
      const_cast<int32_t*>(static_cast<const int32_t*>(counts)),
      static_cast<const int64_t*>(ends), static_cast<int64_t*>(pair_row),
      static_cast<int64_t*>(pair_point));
  return static_cast<int>(cudaGetLastError());
}

// The sum: counts and ends (n,) as the fill pass took them, contrib (P, 3)
// float32 in pair order, phi (n, 3) and mi (n,) float32 -> phi_out, mi_out
// of the same shapes.
extern "C" int goblin_sppm_drain_sum(int64_t n, const void* counts,
                                     const void* ends, const void* contrib,
                                     const void* phi, const void* mi,
                                     void* phi_out, void* mi_out,
                                     void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  sum_kernel<<<blocks_for(n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(ends), static_cast<const float*>(contrib),
      static_cast<const float*>(phi), static_cast<const float*>(mi),
      static_cast<float*>(phi_out), static_cast<float*>(mi_out));
  return static_cast<int>(cudaGetLastError());
}
