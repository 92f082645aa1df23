// Binary-BVH ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel goblin_tpu/ops/pallas_trace.py::_make_kernel
// (entry trace_packets), the trace width-1 path. It computes the same
// function: for each ray (o, d, mint, maxt) walk the binary skip-link BVH
// in pack_scene's per-node layout, test both children's boxes at the
// parent, push the hit ones with the nearer child last (ties go to the
// left child), skip a popped entry whose entry distance exceeds the ray's
// best t, and test leaf triangles with Moller-Trumbore (edge eps 1e-7,
// accept mint <= t <= t_best, so the last of equal-t triangles wins). The
// root is pushed without a box test. The TPU kernel walks 1024-ray packets
// on one shared stack; here each thread walks its own ray on its own stack.
//
// What bounds it on the card: the chain of dependent node fetches (pop ->
// load meta -> two box tests -> push) and warp divergence, not bytes or
// FLOPs: a binary walk makes about four times as many visits as the 8-wide
// one for the same rays, each a short dependent step. The design answers
// with one thread per ray, a node in two float4 of bounds plus one int4
// of meta (one 16-byte load resolves both children, the right child being
// baked into the inner node's first field), and read-only __restrict__
// loads. A first, plain version: no shared-memory staging.
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
// which keeps the kernel and its plain version (trace_bin_plain) bit-close.

#include <cuda_runtime.h>

namespace {

constexpr int kStack = 32;  // ops/trace.py BIN_STACK
constexpr float kBigT = 3.0e38f;
constexpr float kTiny = 1e-30f;
constexpr float kTriEps = 1e-7f;
constexpr int kThreads = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, inx, iny, inz, mint;
};

// entry distance of node j's box, or kBigT where the ray misses it within
// [mint, t_best]
__device__ __forceinline__ float box_entry(const float4* __restrict__ bounds,
                                           int j, const Ray& r,
                                           float t_best) {
  const float4 a = bounds[2 * j], b = bounds[2 * j + 1];
  const float t0x = (a.x - r.ox) * r.inx, t1x = (a.w - r.ox) * r.inx;
  const float t0y = (a.y - r.oy) * r.iny, t1y = (b.x - r.oy) * r.iny;
  const float t0z = (a.z - r.oz) * r.inz, t1z = (b.y - r.oz) * r.inz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tn = fmaxf(tn, r.mint);
  tf = fminf(tf, t_best);
  return tn <= tf ? tn : kBigT;
}

__global__ void __launch_bounds__(kThreads)
trace_bvh2_kernel(const float4* __restrict__ bounds,
                  const int4* __restrict__ meta,
                  const float4* __restrict__ tris,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ mint_in,
                  const float* __restrict__ maxt_in, int n_rays, int any_hit,
                  bool* __restrict__ hit_out, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ b1_out,
                  float* __restrict__ b2_out, int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.mint = mint_in[i];
  r.inx = 1.0f / (r.dx == 0.0f ? kTiny : r.dx);
  r.iny = 1.0f / (r.dy == 0.0f ? kTiny : r.dy);
  r.inz = 1.0f / (r.dz == 0.0f ? kTiny : r.dz);

  float t_best = fminf(maxt_in[i], kBigT);
  int tri_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;

  int stack[kStack];
  float stack_tn[kStack];
  stack[0] = 0;  // the root, never culled
  stack_tn[0] = -kBigT;
  int sp = 1;

  bool done = false;
  while (sp > 0 && !done) {
    --sp;
    const int node = stack[sp];
    if (stack_tn[sp] > t_best) continue;  // entered beyond the best hit
    const int4 m = meta[node];
    if (m.y == 0) {
      // inner node: box-test both children here, push the nearer last
      const int left = node + 1, right = m.x;
      const float min_l = box_entry(bounds, left, r, t_best);
      const float min_r = box_entry(bounds, right, r, t_best);
      const bool l_nearer = min_l <= min_r;
      const int near_node = l_nearer ? left : right;
      const int far_node = l_nearer ? right : left;
      const float near_tn = fminf(min_l, min_r);
      const float far_tn = fmaxf(min_l, min_r);
      const int n_push = (near_tn < kBigT) + (far_tn < kBigT);
      if (sp + n_push > kStack) {
        *overflow = 1;
        break;
      }
      if (far_tn < kBigT) {
        stack[sp] = far_node;
        stack_tn[sp] = far_tn;
        ++sp;
      }
      if (near_tn < kBigT) {
        stack[sp] = near_node;
        stack_tn[sp] = near_tn;
        ++sp;
      }
    } else {
      // leaf: test exactly `count` triangles from `first`
      const int first = m.x, count = m.y;
      for (int k = 0; k < count; ++k) {
        const float4* tr = tris + 3 * (first + k);
        const float4 ta = tr[0], tb = tr[1], tc = tr[2];
        const float v0x = ta.x, v0y = ta.y, v0z = ta.z;
        const float e1x = ta.w, e1y = tb.x, e1z = tb.y;
        const float e2x = tb.z, e2y = tb.w, e2z = tc.x;
        const float s1x = r.dy * e2z - r.dz * e2y;
        const float s1y = r.dz * e2x - r.dx * e2z;
        const float s1z = r.dx * e2y - r.dy * e2x;
        const float div = s1x * e1x + s1y * e1y + s1z * e1z;
        const float inv = 1.0f / (div == 0.0f ? kTiny : div);
        const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
        const float b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
        const float s2x = sy * e1z - sz * e1y;
        const float s2y = sz * e1x - sx * e1z;
        const float s2z = sx * e1y - sy * e1x;
        const float b2 = (r.dx * s2x + r.dy * s2y + r.dz * s2z) * inv;
        const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
        const bool ok = div != 0.0f && b1 + kTriEps >= 0.0f &&
                        b1 - kTriEps <= 1.0f && b2 + kTriEps >= 0.0f &&
                        b1 + b2 - kTriEps <= 1.0f && t >= r.mint &&
                        t <= t_best;
        if (ok) {
          t_best = t;
          tri_best = first + k;
          b1_best = b1;
          b2_best = b2;
          if (any_hit) {
            done = true;
            break;
          }
        }
      }
    }
  }
  const bool hit = tri_best >= 0;
  hit_out[i] = hit;
  t_out[i] = hit ? t_best : kBigT;
  tri_out[i] = tri_best;
  b1_out[i] = b1_best;
  b2_out[i] = b2_best;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 on success).
extern "C" int goblin_trace_bvh2(const void* bounds, const void* meta,
                                 const void* tris, const void* o,
                                 const void* d, const void* mint,
                                 const void* maxt, int n_rays, int any_hit,
                                 void* hit, void* t, void* tri, void* b1,
                                 void* b2, void* overflow, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    trace_bvh2_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(bounds), static_cast<const int4*>(meta),
        static_cast<const float4*>(tris), static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(mint),
        static_cast<const float*>(maxt), n_rays, any_hit,
        static_cast<bool*>(hit), static_cast<float*>(t),
        static_cast<int*>(tri), static_cast<float*>(b1),
        static_cast<float*>(b2), static_cast<int*>(overflow));
  }
  return static_cast<int>(cudaGetLastError());
}
