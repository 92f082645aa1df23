// Wide-BVH ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel goblin_tpu/ops/pallas_trace.py::_make_kernel4
// (entry trace_packets4) at width 8 and, built with -DGOBLIN_TRACE_WIDTH=4
// into a library of its own, at width 4 (what that changes is at the end of
// this comment; the text before it describes width 8). It computes the same
// function: for
// each ray (o, d, mint, maxt) walk the wide BVH that
// goblin_tpu_torch/ops/trace.py::collapse_wide builds from the binary tree,
// slab-test all children of a node, visit the live ones nearest first, and
// test leaf triangles with Moller-Trumbore (edge eps 1e-7, accept
// mint <= t <= t_best, so the last of equal-t triangles wins). The TPU
// kernel walks 1024-ray packets on one shared stack; here every ray has its
// own walk, depth first, and the per-ray order of visits is fixed by the
// sort at each node, so any schedule gives the same result.
//
// What bounds it on this card (NVIDIA H100, bunny: 464 nodes of 224 B,
// 45,224 triangle rows of 48 B): not bytes and not arithmetic. A 196,608-ray
// primary wavefront must move 11.9 MB (3.6 us at 3.35 TB/s) and needs 5.6 M
// box tests (3.99 inner visits a ray, 7.15 child boxes a visit: empty slots
// need none) and 6.0 M triangle tests (1.88 leaf visits a ray, 16.3
// triangles a visit), 0.46 GFLOP or 6.9 us at 67 TFLOP/s, as the plain
// version's census counts them. But one ray's walk is a chain of
// dependent steps (pop -> node -> sort -> push; triangle load -> test ->
// accept) with up to 21 inner and 21 leaf visits, and with a lane to a ray a
// warp runs 8 box tests and up to 32 triangle tests in a row for each visit
// and lasts as long as the longest of its 32 rays. The time is that chain's
// latency times the rounds of warps. What the design does about it:
//
// - Eight lanes to a ray, one for each child slot of a node. An inner visit
//   is one slab test a lane, a rank among the 8 entry distances by shuffles
//   (the stable sort: equal distances keep their slot order) and an OR
//   across the group; a leaf visit tests 8 triangles at a time, one a lane,
//   with the next 8 loaded before the current ones are tested, and a
//   reduction that keeps the sequential accept rule (of the accepted
//   triangles the least t, of equal t the highest index; an any-hit ray
//   takes the lowest accepted index and ends). A visit is one test deep
//   instead of 8 or up to 32, a warp diverges over 4 rays instead of 32, and
//   a walk's state takes 56 registers (59 in the stats instance), so 32
//   warps stay on a multiprocessor.
// - Persistent blocks: as many blocks as stay resident, each group drawing
//   one ray at a time from a counter in device memory until the rays run
//   out, so a short launch spreads over all multiprocessors and a long ray
//   holds 8 lanes, not a block. The groups of a warp reconverge at the top
//   of the loop (__syncwarp), where the compiler joins their draws into one
//   atomic. Drawing 2 or 4 consecutive rays a group at a time was measured
//   1.3x and 1.7x slower per frame, a fixed assignment of rays to groups
//   1.7x (PERF.md).
// - One stack entry per level, not per child: a node id and the list of its
//   live children in visiting order, packed in 32 bits (8 x 4 bits: slot + 1,
//   0 ends the list). The deepest entry lives in registers and the others in
//   shared memory, [level][group]: the lanes of a group write one word with
//   one value and the 4 groups of a warp touch 4 consecutive 8-byte words,
//   so there is no bank conflict; only a change of level touches it. No
//   local memory is left (ptxas: no stack frame).
// - Node reads: the 8 lanes of a group read 8 consecutive floats of each of
//   a node's 6 bound rows and its 8 child entries, 7 sectors of 32 bytes a
//   visit, from L1. The node table is not staged in shared memory: measured
//   on this kernel, with the whole 104 KB table copied by TMA into a block
//   of 1,024 threads a multiprocessor, a frame took 0.1381 ms and a chunk
//   0.0569 ms against 0.1229 and 0.0510, and the same block shape without
//   the copy 0.1418 and 0.0562: the table already sits in L1, which shared
//   memory would shrink, and the small blocks schedule better (PERF.md).
//   The binary kernel (trace_bvh2.cu) does stage its table.
//
// Layout (built on the host, see ops/trace.py):
//   bounds (N8, 6, 8) f32: bmin.x[8], bmin.y[8], bmin.z[8], bmax.x[8], ...
//   child  (N8, 8) i32: inner child = node id >= 0; leaf =
//          -(((first / 8) << 7) | count) - 1; empty slot = -1
//   tris   (T, 12) f32: v0.xyz, e1.xyz, e2.xyz, 3 pad, in BVH order
// Outputs per ray: hit (bool), t (3e38 on a miss), tri (BVH order, -1 on
// a miss), b1, b2. In any-hit mode a ray stops at its first accepted
// triangle. A tree deeper than kLevels sets *overflow (the bake refuses
// such a tree, so it cannot happen for a baked scene).
//
// Built with --fmad=false so products and sums round as in eager PyTorch,
// which keeps the kernel and its plain version (trace_plain) bit-equal.
//
// The stats variant (kStats, K1's `stats` flag) also writes per-ray int32
// counts (inner visits, leaf visits, loop iterations) to stats (R, 3). The
// TPU kernel counted per 1024-ray packet over the packet's union walk; here
// the counts are per ray. Every entry taken off the stack is visited (there
// is no pop-time cull), so iterations = inner + leaf visits. The production
// instance (kStats = false) compiles the counters out.
//
// Width 4 (GOBLIN_TRACE_WIDTH=4; entries goblin_trace_bvh4*): the same
// code with kWidth = 4. A node is 6 x 4 floats of bounds and 4 child
// entries; four lanes walk a ray, so a warp holds 8 rays and a block 32, an
// inner visit is 4 slab tests and a rank over 4 lanes, and a leaf visit
// tests 4 triangles a round (leaves keep up to 32 triangles from 8-aligned
// starts). The packed list uses 4 of a word's 8 nibbles. The tree is deeper
// (bunny's BVH4 has 9 levels, its BVH8 6), so the stack has 16 levels, 15
// of them in shared memory (3,840 B a block). The width-8 instance's code
// is what it was: every width-dependent value is a constant of kWidth
// (ptxas: 56 registers and 1,024 B shared at width 8 as before, 55 and
// 3,840 B at width 4, no stack frame in either). What bounds it is the same
// chain of dependent steps, longer here: on bunny's primary frame a ray
// makes 5.70 inner visits (3.99 at width 8) of 3.90 live boxes and 1.60
// leaf visits of 17.3 triangles, in rounds of 4; but a warp holds 8 walks
// instead of 4. Measured on an NVIDIA H100 (700 W) in one call with width
// 8: 0.137 ms a 196,608-ray primary frame against 0.128, 0.072 ms a
// 65,536-ray chunk against 0.060; the studio scene's continuation frame
// 0.183 against 0.219 (PERF.md has every wavefront).

#include "trace_common.cuh"

#ifndef GOBLIN_TRACE_WIDTH
#define GOBLIN_TRACE_WIDTH 8
#endif

// the C entries' names carry the width: goblin_trace_bvh8, goblin_trace_bvh4
#define GOBLIN_CAT2(a, b) a##b
#define GOBLIN_CAT(a, b) GOBLIN_CAT2(a, b)
#define GOBLIN_ENTRY(suffix) \
  GOBLIN_CAT(GOBLIN_CAT(goblin_trace_bvh, GOBLIN_TRACE_WIDTH), suffix)

namespace {

using namespace goblin;

constexpr int kWidth = GOBLIN_TRACE_WIDTH;
static_assert(kWidth == 8 || kWidth == 4, "the wide kernel is 8 or 4 wide");
constexpr int kEmpty = -1;
// lanes to a ray: one for each child slot of a node
constexpr int kGroup = kWidth;
constexpr int kThreads = 128;
constexpr int kGroups = kThreads / kGroup;  // rays a block walks at once
// blocks that share a multiprocessor: 8 x 128 threads x at most 64 registers
constexpr int kBlocksPerSM = 8;
// inner nodes on the longest root-to-leaf path the walk can hold
// (ops/trace.py WIDE_LEVELS, WIDE4_LEVELS): one stack entry per level
constexpr int kLevels = kWidth == 8 ? 9 : 16;

// The lanes of a group slab-test the children of node e, a child a
// lane. Returns, on every lane, the children the ray enters, nearest first
// (a stable sort on entry distance), packed four bits a child from the low
// end: slot + 1, and 0 ends the list.
__device__ __forceinline__ uint32_t visit_inner(
    const float* __restrict__ bounds, const int* __restrict__ child, int e,
    int c, unsigned gmask, const Ray& r, float t_best) {
  const float kInf = __int_as_float(0x7f800000);  // key of a culled child
  const float* nb = bounds + 6 * kWidth * e + c;
  float tn;
  const bool enters =
      slab_test(r, t_best, nb[0], nb[kWidth], nb[2 * kWidth], nb[3 * kWidth],
                nb[4 * kWidth], nb[5 * kWidth], tn);
  const float key = (child[kWidth * e + c] != kEmpty && enters) ? tn : kInf;
  // this child's place in visiting order: the children that enter nearer,
  // and of those at the same distance the ones in lower slots
  int rank = 0;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float kj = __shfl_sync(gmask, key, j, kGroup);
    rank += (kj < key || (kj == key && j < c)) ? 1 : 0;
  }
  uint32_t list =
      key < kInf ? static_cast<uint32_t>(c + 1) << (4 * rank) : 0u;
#pragma unroll
  for (int step = 1; step < kGroup; step *= 2)
    list |= __shfl_xor_sync(gmask, list, step);
  return list;
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
trace_wide_kernel(const float* __restrict__ bounds,
                  const int* __restrict__ child,
                  const float4* __restrict__ tris,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ mint_in,
                  const float* __restrict__ maxt_in, int n_rays, int any_hit,
                  bool* __restrict__ hit_out, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ b1_out,
                  float* __restrict__ b2_out, int* __restrict__ overflow,
                  int* __restrict__ counter, int* __restrict__ stats) {
  // entry `level` of a group's stack is s_stack[level][group]
  __shared__ uint2 s_stack[kLevels - 1][kGroups];
  const int lane = threadIdx.x & 31;
  const int c = lane & (kGroup - 1);            // this lane's child slot
  const unsigned gmask = ((1u << kGroup) - 1u)
                         << (lane & ~(kGroup - 1));  // its group
  const int g = threadIdx.x / kGroup;

  // Each group walks one ray at a time, and all of its lanes hold the same
  // walk: `i` is the ray (-1: none) and `have` says that the walk has an
  // entry `e` to visit. The stack holds one entry per level: a node and its
  // packed list of children still to visit, with the deepest level in
  // (top_node, top_list).
  int i = -1;
  bool have = false;
  Ray r = {};
  Best best = {0.0f, -1, 0.0f, 0.0f};
  int e = 0, top_node = 0, sp = 0;
  uint32_t top_list = 0;
  int n_inner = 0, n_leaf = 0;

  auto pop = [&]() -> bool {
    if (top_list == 0) {
      if (sp == 0) return false;
      const uint2 v = s_stack[--sp][g];
      top_node = static_cast<int>(v.x);
      top_list = v.y;
    }
    const int slot = static_cast<int>(top_list & 15u) - 1;
    top_list >>= 4;
    e = child[top_node * kWidth + slot];
    return true;
  };

  for (;;) {
    // the groups of a warp meet here, so those whose rays have ended draw
    // their next rays together
    __syncwarp();
    if (!have) {
      // the group's ray has ended: write it out and draw the next
      if (i >= 0 && c == 0) {
        const bool hit = best.tri >= 0;
        hit_out[i] = hit;
        t_out[i] = hit ? best.t : kBigT;
        tri_out[i] = best.tri;
        b1_out[i] = best.b1;
        b2_out[i] = best.b2;
        if (kStats) {
          stats[3 * i] = n_inner;
          stats[3 * i + 1] = n_leaf;
          stats[3 * i + 2] = n_inner + n_leaf;  // every pop visits a node
        }
      }
      i = next_ray(counter, c, gmask, kGroup);
      if (i >= n_rays) break;
      r = load_ray(o, d, mint_in, i);
      best.t = fminf(maxt_in[i], kBigT);
      best.tri = -1;
      best.b1 = best.b2 = 0.0f;
      e = 0;
      top_list = 0;
      sp = 0;
      n_inner = n_leaf = 0;
      have = r.mint < best.t;  // a dead ray skips the root
      if (!have) continue;
    }

    // inner phase: walk inner nodes until a leaf is pending or the ray ends
    while (have && e >= 0) {
      if (kStats) ++n_inner;
      const uint32_t list =
          visit_inner(bounds, child, e, c, gmask, r, best.t);
      if (list != 0) {
        if (top_list != 0) {
          if (sp == kLevels - 1) {
            *overflow = 1;
            have = false;
            break;
          }
          s_stack[sp++][g] =
              make_uint2(static_cast<uint32_t>(top_node), top_list);
        }
        top_node = e;
        top_list = list;
      }
      have = pop();
    }
    if (!have) continue;

    // leaf phase: exactly `count` triangles from `first`
    if (kStats) ++n_leaf;
    const int dec = -(e + 1);
    const bool done = leaf_tests_group<kGroup>(tris, (dec >> 7) * 8,
                                               dec & 127, c, gmask, r,
                                               any_hit, best);
    have = !done && pop();
  }
}

// Blocks for a launch of n_rays rays: those that stay resident at once, or
// fewer where the rays do not fill them.
template <bool kStats>
cudaError_t plan_blocks(int n_rays, int* blocks) {
  static LaunchPlan<decltype(&trace_wide_kernel<kStats>)> plan;
  const cudaError_t err =
      plan.blocks(&trace_wide_kernel<kStats>, kThreads, 0, blocks);
  if (err != cudaSuccess) return err;
  const int needed = (n_rays + kGroups - 1) / kGroups;
  if (needed < *blocks) *blocks = needed;
  return cudaSuccess;
}

template <bool kStats>
int launch(const void* bounds, const void* child, const void* tris,
           const void* o, const void* d, const void* mint, const void* maxt,
           int n_rays, int any_hit, void* hit, void* t, void* tri, void* b1,
           void* b2, void* overflow, void* counter, void* stats,
           void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int blocks = 0;
  const cudaError_t err = plan_blocks<kStats>(n_rays, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_wide_kernel<kStats><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bounds), static_cast<const int*>(child),
      static_cast<const float4*>(tris), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(mint),
      static_cast<const float*>(maxt), n_rays, any_hit,
      static_cast<bool*>(hit), static_cast<float*>(t), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<int*>(overflow), static_cast<int*>(counter),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success). overflow and
// counter point at zeroed int32 words.
extern "C" int GOBLIN_ENTRY()(const void* bounds, const void* child,
                              const void* tris, const void* o, const void* d,
                              const void* mint, const void* maxt, int n_rays,
                              int any_hit, void* hit, void* t, void* tri,
                              void* b1, void* b2, void* overflow,
                              void* counter, void* stream) {
  return launch<false>(bounds, child, tris, o, d, mint, maxt, n_rays, any_hit,
                       hit, t, tri, b1, b2, overflow, counter, nullptr,
                       stream);
}

// The stats variant: stats is (n_rays, 3) int32.
extern "C" int GOBLIN_ENTRY(_stats)(const void* bounds, const void* child,
                                    const void* tris, const void* o,
                                    const void* d, const void* mint,
                                    const void* maxt, int n_rays, int any_hit,
                                    void* hit, void* t, void* tri, void* b1,
                                    void* b2, void* overflow, void* counter,
                                    void* stats, void* stream) {
  return launch<true>(bounds, child, tris, o, d, mint, maxt, n_rays, any_hit,
                      hit, t, tri, b1, b2, overflow, counter, stats, stream);
}

// *out = the blocks that a launch of n_rays rays runs on the current device.
extern "C" int GOBLIN_ENTRY(_blocks)(int n_rays, int* out) {
  return static_cast<int>(plan_blocks<false>(n_rays, out));
}
