// Binary-BVH ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel goblin_tpu/ops/pallas_trace.py::_make_kernel
// (entry trace_packets), the trace width-1 path. It computes the same
// function: for each ray (o, d, mint, maxt) walk the binary skip-link BVH
// in pack_scene's per-node layout, test both children's boxes at the
// parent, visit the nearer child first (ties go to the left child) and the
// farther later, skip an entry whose entry distance exceeds the ray's best
// t by then, and test leaf triangles with Moller-Trumbore (edge eps 1e-7,
// accept mint <= t <= t_best, so the last of equal-t triangles wins). The
// root is visited without a box test. The TPU kernel walks 1024-ray packets
// on one shared stack; here every lane walks its own ray, depth first.
//
// What bounds it on this card (NVIDIA H100, bunny: 3,501 nodes of 48 B,
// 45,224 triangle rows of 48 B): not bytes and not arithmetic. A 196,608-ray
// primary wavefront must move 12.0 MB (3.6 us at 3.35 TB/s) and needs 3.9 M
// box tests and 5.1 M triangle tests (9.91 inner visits, 1.55 leaf visits
// and 25.9 triangles a ray), 0.37 GFLOP or 5.5 us at 67 TFLOP/s. But a
// binary walk is a long chain of short dependent steps (pop -> meta -> two
// box tests -> push; triangle load -> test -> accept), a warp lasts as long
// as its longest ray, and 16 warps to a multiprocessor hide only part of
// that. The time is latency times the rounds of warps. What the design does
// about it:
//
// - Persistent blocks: one block of 512 threads to a multiprocessor, each
//   warp drawing 32 consecutive rays at a time from a counter in device
//   memory until the rays run out.
// - The node table in shared memory, copied by TMA: at block start warp 0
//   issues bulk asynchronous copies (4 KB each) of the first n_staged nodes'
//   bounds and meta rows, and a warp waits on their mbarrier only after it
//   has loaded its first rays. A visit of node j < n_staged reads shared
//   memory, any other device memory, so a tree of any size runs; bunny's 168
//   KB fit whole. The rows keep their device layout: 32 lanes on 32 different
//   nodes read a 16-byte meta row each from 8 distinct bank groups (no
//   conflict beyond the 4 wavefronts 512 bytes take) and two 16-byte halves
//   of a 32-byte bounds row, which fall on 4 of the 8 bank groups (2-way
//   conflicts at worst); lanes on the same node share one broadcast.
// - The nearer child stays in registers instead of going through the stack,
//   so the stack holds only far children: at most one (node, entry distance)
//   pair per level. It stays in local memory (ptxas: a 256-byte frame): 32
//   levels x 8 bytes x 512 threads would take 128 KB of the shared memory
//   the nodes use, and a 16-level stack in shared memory with 256 threads a
//   block was measured faster on the primary rays and slower on the
//   continuation (PERF.md).
// - Inner nodes and leaves in separate phases: each lane walks inner nodes
//   until a leaf is pending, then the warp turns to the leaves, so its lanes
//   run the same arm together. While at most 16 lanes have a leaf pending
//   the warp takes them one after another with a triangle to a lane (a leaf
//   holds at most 32), one test deep instead of up to 32 in a row, and a
//   reduction keeps the sequential accept rule; above 16 every lane tests
//   its own leaf with the loads of 4 triangles issued ahead of their tests.
//   Eight lanes to a ray, the BVH8 kernel's form, was measured here too:
//   faster per 65,536-ray chunk, but slower per 32,768-photon launch and
//   equal per frame, the two shapes a width-1 render launches, so the
//   lane-to-a-ray walk stays (PERF.md).
//
// Layout (built on the host, see ops/trace.py::bin_tables):
//   bounds (N, 8) f32: bmin.xyz, bmax.xyz, 0, 0
//   meta   (N, 4) i32: [first tri | right child, count (0 = inner), miss, 0]
//   tris   (T, 12) f32: v0.xyz, e1.xyz, e2.xyz, 3 pad, in BVH order
// Outputs per ray: hit (bool), t (3e38 on a miss), tri (BVH order, -1 on
// a miss), b1, b2. In any-hit mode a ray stops at its first accepted
// triangle. A stack deeper than kStack sets *overflow (the bake bounds
// the tree depth so it cannot happen for a baked scene).
//
// Built with --fmad=false so products and sums round as in eager PyTorch,
// which keeps the kernel and its plain version (trace_bin_plain) bit-equal.

#include "trace_common.cuh"

namespace {

using namespace goblin;

constexpr int kStack = 32;  // ops/trace.py BIN_STACK
constexpr int kThreads = 512;
// blocks that share a multiprocessor (and its shared memory)
constexpr int kBlocksPerSM = 1;
constexpr int kBoundsBytes = 32;  // a node's two float4 of bounds
constexpr int kMetaBytes = 16;    // and its int4 of meta

__host__ __device__ constexpr int smem_bytes(int n_staged) {
  return kSmemHeader + n_staged * (kBoundsBytes + kMetaBytes);
}

// entry distance of a box whose two float4 start at nb, or kBigT where the
// ray misses it within [mint, t_best]
__device__ __forceinline__ float box_entry(const float4* nb, const Ray& r,
                                           float t_best) {
  const float4 a = nb[0], b = nb[1];
  float tn;
  return slab_test(r, t_best, a.x, a.y, a.z, a.w, b.x, b.y, tn) ? tn : kBigT;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
trace_bvh2_kernel(const float4* __restrict__ bounds,
                  const int4* __restrict__ meta,
                  const float4* __restrict__ tris,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ mint_in,
                  const float* __restrict__ maxt_in, int n_rays, int any_hit,
                  int n_staged, bool* __restrict__ hit_out,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  float* __restrict__ b1_out, float* __restrict__ b2_out,
                  int* __restrict__ overflow, int* __restrict__ counter) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const float4* s_bounds = reinterpret_cast<const float4*>(smem + kSmemHeader);
  const int4* s_meta = reinterpret_cast<const int4*>(
      smem + kSmemHeader + n_staged * kBoundsBytes);
  uint2 stack[kStack];  // (node, bits of its entry distance)

  // stage the first n_staged nodes: warp 0 issues the bulk copies, and
  // no warp waits for them until its first rays are loaded
  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x < 32 && n_staged > 0) {
    if (threadIdx.x == 0)
      mbar_expect_tx(bar, n_staged * (kBoundsBytes + kMetaBytes));
    __syncwarp();
    stage_bytes(smem + kSmemHeader, bounds, n_staged * kBoundsBytes, bar);
    stage_bytes(smem + kSmemHeader + n_staged * kBoundsBytes, meta,
                n_staged * kMetaBytes, bar);
  }
  bool staged = n_staged == 0;

  // Each lane walks one ray at a time: `i` is its ray (-1: none) and
  // `have` says that the walk has an entry to visit: a node and the
  // distance `tn` at which the ray enters its box. The stack holds the far
  // children still to visit. The root is never culled.
  int i = -1;
  bool have = false;
  Ray r = {};
  Best best = {0.0f, -1, 0.0f, 0.0f};
  int node = 0, sp = 0;
  float tn = -kBigT;
  int first = 0, count = 0;  // the pending leaf

  auto pop = [&]() -> bool {
    if (sp == 0) return false;
    --sp;
    const uint2 v = stack[sp];
    node = static_cast<int>(v.x);
    tn = __uint_as_float(v.y);
    return true;
  };

  auto entry_of = [&](int j) -> float {
    if (j < n_staged) return box_entry(s_bounds + 2 * j, r, best.t);
    return box_entry(bounds + 2 * j, r, best.t);
  };

  for (;;) {
    // a lane whose ray has ended writes it out
    if (!have && i >= 0) {
      const bool hit = best.tri >= 0;
      hit_out[i] = hit;
      t_out[i] = hit ? best.t : kBigT;
      tri_out[i] = best.tri;
      b1_out[i] = best.b1;
      b2_out[i] = best.b2;
      i = -1;
    }
    // a warp whose rays have all ended draws the next 32
    if (!__any_sync(kFullMask, have)) {
      const int base = next_batch(counter);
      if (base >= n_rays) {
        // no block ends while its bulk copies are in flight
        if (!staged) mbar_wait(bar, 0);
        break;
      }
      if (base + (threadIdx.x & 31) < n_rays) {
        i = base + (threadIdx.x & 31);
        r = load_ray(o, d, mint_in, i);
        best.t = fminf(maxt_in[i], kBigT);
        best.tri = -1;
        best.b1 = best.b2 = 0.0f;
        node = 0;
        tn = -kBigT;
        sp = 0;
        have = true;
      }
      continue;
    }
    if (!staged) {
      mbar_wait(bar, 0);
      staged = true;
    }

    // inner phase: walk inner nodes until a leaf is pending or the ray ends
    while (have) {
      if (tn > best.t) {  // entered beyond the best hit
        have = pop();
        continue;
      }
      int4 m;
      if (node < n_staged)
        m = s_meta[node];
      else
        m = meta[node];
      if (m.y != 0) {
        first = m.x;
        count = m.y;
        break;
      }
      // inner node: box-test both children here, visit the nearer first
      // (ties go to the left child) and stack the farther
      const int left = node + 1, right = m.x;
      const float min_l = entry_of(left), min_r = entry_of(right);
      const bool l_nearer = min_l <= min_r;
      const float near_tn = fminf(min_l, min_r);
      const float far_tn = fmaxf(min_l, min_r);
      if (far_tn < kBigT) {
        if (sp == kStack) {
          *overflow = 1;
          have = false;
          break;
        }
        stack[sp] = make_uint2(
            static_cast<uint32_t>(l_nearer ? right : left),
            __float_as_uint(far_tn));
        ++sp;
      }
      if (near_tn < kBigT) {
        node = l_nearer ? left : right;
        tn = near_tn;
      } else {
        have = pop();
      }
    }
    // leaf phase: exactly `count` triangles from `first` for each lane
    // that has one pending
    const unsigned pending = __ballot_sync(kFullMask, have);
    if (pending == 0) continue;
    bool done;
    if (__popc(pending) <= kCoopMax)
      done = leaf_tests_warp(tris, pending, first, count, r, any_hit, best);
    else
      done = have && leaf_tests(tris, first, count, r, any_hit, best);
    if (have) have = !done && pop();
  }
}

// Blocks for a launch of n_rays rays with n_staged nodes staged: those that
// stay resident at once, or fewer where the rays do not fill them.
cudaError_t plan_blocks(int n_rays, int n_staged, int* blocks) {
  static LaunchPlan<decltype(&trace_bvh2_kernel)> plan;
  const cudaError_t err = plan.blocks(&trace_bvh2_kernel, kThreads,
                                      smem_bytes(n_staged), blocks);
  if (err != cudaSuccess) return err;
  const int needed = (n_rays + kThreads - 1) / kThreads;
  if (needed < *blocks) *blocks = needed;
  return cudaSuccess;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 on success). n_staged nodes are staged
// in shared memory (ops/trace.py::staged_nodes), and overflow and counter
// point at zeroed int32 words.
extern "C" int goblin_trace_bvh2(const void* bounds, const void* meta,
                                 const void* tris, const void* o,
                                 const void* d, const void* mint,
                                 const void* maxt, int n_rays, int any_hit,
                                 int n_staged, void* hit, void* t, void* tri,
                                 void* b1, void* b2, void* overflow,
                                 void* counter, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int blocks = 0;
  const cudaError_t err = plan_blocks(n_rays, n_staged, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_bvh2_kernel<<<blocks, kThreads, smem_bytes(n_staged),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(bounds), static_cast<const int4*>(meta),
      static_cast<const float4*>(tris), static_cast<const float*>(o),
      static_cast<const float*>(d), static_cast<const float*>(mint),
      static_cast<const float*>(maxt), n_rays, any_hit, n_staged,
      static_cast<bool*>(hit), static_cast<float*>(t), static_cast<int*>(tri),
      static_cast<float*>(b1), static_cast<float*>(b2),
      static_cast<int*>(overflow), static_cast<int*>(counter));
  return static_cast<int>(cudaGetLastError());
}

// *out = the blocks that such a launch runs on the current device.
extern "C" int goblin_trace_bvh2_blocks(int n_rays, int n_staged, int* out) {
  return static_cast<int>(plan_blocks(n_rays, n_staged, out));
}

// out[0..4] = threads per block, per-ray stack entries, shared-memory bytes
// of a staged node, of a block beside its nodes, and the bytes a block may
// take on the current device (kBlocksPerSM blocks to a multiprocessor).
extern "C" int goblin_trace_bvh2_config(int* out) {
  out[0] = kThreads;
  out[1] = kStack;
  out[2] = kBoundsBytes + kMetaBytes;
  out[3] = smem_bytes(0);
  return static_cast<int>(smem_budget(kBlocksPerSM, &out[4]));
}
