// BVH8 ray traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel goblin_tpu/ops/pallas_trace.py::_make_kernel4
// (entry trace_packets4) at width 8. It computes the same function: for
// each ray (o, d, mint, maxt) walk the 8-wide BVH that
// goblin_tpu_torch/ops/trace.py::collapse8 builds from the binary tree,
// slab-test all children of a node, push the live ones near-first, and
// test leaf triangles with Moller-Trumbore (edge eps 1e-7, accept
// mint <= t <= t_best). The TPU kernel walks 1024-ray packets on one
// shared stack; on the GPU each thread walks its own ray on its own stack.
//
// What bounds it on the card: the dependent chain of node fetches (pop ->
// load node -> slab tests -> push) and warp divergence between rays that
// take different paths, not bytes or FLOPs. The bunny scene's tables are
// about 3 MB and sit in the 50 MB L2 cache. The design answers with one
// thread per ray (no packet union of node sets), node and triangle rows
// laid out for 16-byte loads (a node is 12 float4 of bounds plus 2 int4 of
// child entries; a triangle is 3 float4), and read-only __restrict__ loads.
// A first, plain version: no shared-memory staging or persistent threads.
//
// Layout (built on the host, see ops/trace.py):
//   bounds (N8, 6, 8) f32: bmin.x[8], bmin.y[8], bmin.z[8], bmax.x[8], ...
//   child  (N8, 8) i32: inner child = node id >= 0; leaf =
//          -(((first / 8) << 7) | count) - 1; empty slot = -1
//   tris   (T, 12) f32: v0.xyz, e1.xyz, e2.xyz, 3 pad, in BVH order
// Outputs per ray: hit (bool), t (3e38 on a miss), tri (BVH order, -1 on
// a miss), b1, b2. In any-hit mode a ray stops at its first accepted
// triangle. A stack deeper than kStack sets *overflow (the host bounds
// the tree depth so it cannot happen for a baked scene).
//
// Built with --fmad=false so products and sums round as in eager PyTorch,
// which keeps the kernel and its plain version (trace_plain) bit-close.
//
// The stats variant (kStats, K1's `stats` flag) also writes per-ray int32
// counts (inner visits, leaf visits, loop iterations) to stats (R, 3). The
// TPU kernel counted per 1024-ray packet over the packet's union walk; here
// the counts are per ray. Every pop visits a node (there is no pop-time
// cull), so iterations = inner + leaf visits. The production instance
// (kStats = false) compiles the counters out.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 8;
constexpr int kStack = 64;
constexpr int kEmpty = -1;
constexpr float kBigT = 3.0e38f;
constexpr float kTiny = 1e-30f;
constexpr float kTriEps = 1e-7f;
constexpr int kThreads = 128;

__device__ __forceinline__ void sort_pair(float& ka, int& ea, float& kb,
                                          int& eb) {
  // after: ka <= kb; equal keys keep their order
  if (ka > kb) {
    float tk = ka; ka = kb; kb = tk;
    int te = ea; ea = eb; eb = te;
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
trace_bvh8_kernel(const float4* __restrict__ bounds,
                  const int4* __restrict__ child,
                  const float4* __restrict__ tris,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ mint_in,
                  const float* __restrict__ maxt_in, int n_rays, int any_hit,
                  bool* __restrict__ hit_out, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ b1_out,
                  float* __restrict__ b2_out, int* __restrict__ overflow,
                  int* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int n_inner = 0, n_leaf = 0, n_iter = 0;
  const float kInf = __int_as_float(0x7f800000);  // key of a culled child
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float mint = mint_in[i];
  const float inx = 1.0f / (dx == 0.0f ? kTiny : dx);
  const float iny = 1.0f / (dy == 0.0f ? kTiny : dy);
  const float inz = 1.0f / (dz == 0.0f ? kTiny : dz);

  float t_best = fminf(maxt_in[i], kBigT);
  int tri_best = -1;
  float b1_best = 0.0f, b2_best = 0.0f;

  int stack[kStack];
  int sp = 0;
  if (mint < t_best) stack[sp++] = 0;  // a dead lane skips the root

  bool done = false;
  while (sp > 0 && !done) {
    const int e = stack[--sp];
    if (kStats) ++n_iter;
    if (e >= 0) {
      // inner node: slab-test the 8 children
      if (kStats) ++n_inner;
      const float4* nb = bounds + 12 * e;
      const int4 c0 = child[2 * e], c1 = child[2 * e + 1];
      int ent[kWidth] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      float lo[6][kWidth];
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        const float4 a = nb[2 * p], b = nb[2 * p + 1];
        lo[p][0] = a.x; lo[p][1] = a.y; lo[p][2] = a.z; lo[p][3] = a.w;
        lo[p][4] = b.x; lo[p][5] = b.y; lo[p][6] = b.z; lo[p][7] = b.w;
      }
      float key[kWidth];
#pragma unroll
      for (int c = 0; c < kWidth; ++c) {
        const float t0x = (lo[0][c] - ox) * inx, t1x = (lo[3][c] - ox) * inx;
        const float t0y = (lo[1][c] - oy) * iny, t1y = (lo[4][c] - oy) * iny;
        const float t0z = (lo[2][c] - oz) * inz, t1z = (lo[5][c] - oz) * inz;
        float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
        float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
        tn = fmaxf(tn, mint);
        tf = fminf(tf, t_best);
        key[c] = (ent[c] != kEmpty && tn <= tf) ? tn : kInf;
      }
      // stable ascending sort by entry distance (odd-even transposition:
      // adjacent swaps only, so equal keys keep their slot order)
#pragma unroll
      for (int r = 0; r < kWidth; ++r) {
#pragma unroll
        for (int c = r & 1; c + 1 < kWidth; c += 2)
          sort_pair(key[c], ent[c], key[c + 1], ent[c + 1]);
      }
      int n_keep = 0;
#pragma unroll
      for (int c = 0; c < kWidth; ++c) n_keep += key[c] < kInf;
      if (sp + n_keep > kStack) {
        *overflow = 1;
        break;
      }
      // push far -> near so the nearest child pops first
#pragma unroll
      for (int c = kWidth - 1; c >= 0; --c)
        if (c < n_keep) stack[sp++] = ent[c];
    } else {
      // leaf: test exactly `count` triangles from `first`
      if (kStats) ++n_leaf;
      const int dec = -(e + 1);
      const int count = dec & 127;
      const int first = (dec >> 7) * 8;
      for (int k = 0; k < count; ++k) {
        const float4* tr = tris + 3 * (first + k);
        const float4 ta = tr[0], tb = tr[1], tc = tr[2];
        const float v0x = ta.x, v0y = ta.y, v0z = ta.z;
        const float e1x = ta.w, e1y = tb.x, e1z = tb.y;
        const float e2x = tb.z, e2y = tb.w, e2z = tc.x;
        const float s1x = dy * e2z - dz * e2y;
        const float s1y = dz * e2x - dx * e2z;
        const float s1z = dx * e2y - dy * e2x;
        const float div = s1x * e1x + s1y * e1y + s1z * e1z;
        const float inv = 1.0f / (div == 0.0f ? kTiny : div);
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
        const float s2x = sy * e1z - sz * e1y;
        const float s2y = sz * e1x - sx * e1z;
        const float s2z = sx * e1y - sy * e1x;
        const float b2 = (dx * s2x + dy * s2y + dz * s2z) * inv;
        const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
        const bool ok = div != 0.0f && b1 + kTriEps >= 0.0f &&
                        b1 - kTriEps <= 1.0f && b2 + kTriEps >= 0.0f &&
                        b1 + b2 - kTriEps <= 1.0f && t >= mint && t <= t_best;
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
  if (kStats) {
    stats[3 * i] = n_inner;
    stats[3 * i + 1] = n_leaf;
    stats[3 * i + 2] = n_iter;
  }
}

template <bool kStats>
int launch(const void* bounds, const void* child, const void* tris,
           const void* o, const void* d, const void* mint, const void* maxt,
           int n_rays, int any_hit, void* hit, void* t, void* tri, void* b1,
           void* b2, void* overflow, void* stats, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    trace_bvh8_kernel<kStats><<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(bounds), static_cast<const int4*>(child),
        static_cast<const float4*>(tris), static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(mint),
        static_cast<const float*>(maxt), n_rays, any_hit,
        static_cast<bool*>(hit), static_cast<float*>(t),
        static_cast<int*>(tri), static_cast<float*>(b1),
        static_cast<float*>(b2), static_cast<int*>(overflow),
        static_cast<int*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int goblin_trace_bvh8(const void* bounds, const void* child,
                                 const void* tris, const void* o,
                                 const void* d, const void* mint,
                                 const void* maxt, int n_rays, int any_hit,
                                 void* hit, void* t, void* tri, void* b1,
                                 void* b2, void* overflow, void* stream) {
  return launch<false>(bounds, child, tris, o, d, mint, maxt, n_rays, any_hit,
                       hit, t, tri, b1, b2, overflow, nullptr, stream);
}

// The stats variant: stats is (n_rays, 3) int32.
extern "C" int goblin_trace_bvh8_stats(const void* bounds, const void* child,
                                       const void* tris, const void* o,
                                       const void* d, const void* mint,
                                       const void* maxt, int n_rays,
                                       int any_hit, void* hit, void* t,
                                       void* tri, void* b1, void* b2,
                                       void* overflow, void* stats,
                                       void* stream) {
  return launch<true>(bounds, child, tris, o, d, mint, maxt, n_rays, any_hit,
                      hit, t, tri, b1, b2, overflow, stats, stream);
}
