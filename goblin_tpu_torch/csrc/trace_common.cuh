// What the two BVH traversal kernels (trace_bvh8.cu, trace_bvh2.cu) share:
// the ray load, the slab test, the Moller-Trumbore leaf tests (a lane on its
// own leaf, a group of lanes or the whole warp on one leaf together), the
// persistent blocks' ray fetch, the bulk-copy (TMA) staging of a node table
// into shared memory, and the host's launch plan.
//
// Arithmetic is written once here so both kernels round alike; both are
// built with --fmad=false, so every product and sum rounds as in eager
// PyTorch and the kernels stay bit-equal to their plain versions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace goblin {

constexpr float kBigT = 3.0e38f;
constexpr float kTiny = 1e-30f;
constexpr float kTriEps = 1e-7f;
constexpr unsigned kFullMask = 0xffffffffu;
// triangles whose loads are issued together ahead of their tests
constexpr int kLeafBatch = 4;
// the warp tests its pending leaves together, a triangle to a lane, while at
// most this many lanes have one; above it every lane tests its own leaf
constexpr int kCoopMax = 16;
// bytes one bulk copy moves when a contiguous table is staged
constexpr uint32_t kStageChunk = 4096;
// the mbarrier's slot at the start of dynamic shared memory
constexpr int kSmemHeader = 16;

struct Ray {
  float ox, oy, oz, dx, dy, dz, inx, iny, inz, mint;
};

// best hit so far; t doubles as the ray's current maxt
struct Best {
  float t;
  int tri;
  float b1, b2;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ mint,
                                        int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.mint = mint[i];
  r.inx = 1.0f / (r.dx == 0.0f ? kTiny : r.dx);
  r.iny = 1.0f / (r.dy == 0.0f ? kTiny : r.dy);
  r.inz = 1.0f / (r.dz == 0.0f ? kTiny : r.dz);
  return r;
}

// Slab test of box [lo, hi] against the ray clipped to [mint, t_best]:
// true where the ray enters the box, with its entry distance in tn.
__device__ __forceinline__ bool slab_test(const Ray& r, float t_best,
                                          float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          float& tn) {
  const float t0x = (lx - r.ox) * r.inx, t1x = (hx - r.ox) * r.inx;
  const float t0y = (ly - r.oy) * r.iny, t1y = (hy - r.oy) * r.iny;
  const float t0z = (lz - r.oz) * r.inz, t1z = (hz - r.oz) * r.inz;
  const float t_in =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float t_out =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tn = fmaxf(t_in, r.mint);
  return tn <= fminf(t_out, t_best);
}

struct Tri {
  float4 a, b, c;  // v0.xyz e1.x | e1.yz e2.xy | e2.z pad
};

__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris,
                                        int idx) {
  const float4* p = tris + 3 * idx;
  Tri tr;
  tr.a = __ldg(p);
  tr.b = __ldg(p + 1);
  tr.c = __ldg(p + 2);
  return tr;
}

// Moller-Trumbore with edge eps 1e-7; accepts mint <= t <= best.t.
__device__ __forceinline__ bool tri_test(const Tri& tr, const Ray& r,
                                         float t_best, float& t, float& b1,
                                         float& b2) {
  const float v0x = tr.a.x, v0y = tr.a.y, v0z = tr.a.z;
  const float e1x = tr.a.w, e1y = tr.b.x, e1z = tr.b.y;
  const float e2x = tr.b.z, e2y = tr.b.w, e2z = tr.c.x;
  const float s1x = r.dy * e2z - r.dz * e2y;
  const float s1y = r.dz * e2x - r.dx * e2z;
  const float s1z = r.dx * e2y - r.dy * e2x;
  const float div = s1x * e1x + s1y * e1y + s1z * e1z;
  const float inv = 1.0f / (div == 0.0f ? kTiny : div);
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  b1 = (sx * s1x + sy * s1y + sz * s1z) * inv;
  const float s2x = sy * e1z - sz * e1y;
  const float s2y = sz * e1x - sx * e1z;
  const float s2z = sx * e1y - sy * e1x;
  b2 = (r.dx * s2x + r.dy * s2y + r.dz * s2z) * inv;
  t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv;
  return div != 0.0f && b1 + kTriEps >= 0.0f && b1 - kTriEps <= 1.0f &&
         b2 + kTriEps >= 0.0f && b1 + b2 - kTriEps <= 1.0f && t >= r.mint &&
         t <= t_best;
}

// Test triangles first .. first + count - 1 in order. The loads of
// kLeafBatch triangles are issued before the first of their tests (no load
// depends on a test), while the accept rule stays sequential: of equal t
// the last triangle wins, and an any-hit ray stops at its first accepted
// triangle (returns true). Indices past the leaf are clamped to its last
// triangle and their tests skipped, so no load leaves the table.
__device__ __forceinline__ bool leaf_tests(const float4* __restrict__ tris,
                                           int first, int count,
                                           const Ray& r, int any_hit,
                                           Best& best) {
  for (int k = 0; k < count; k += kLeafBatch) {
    Tri tr[kLeafBatch];
#pragma unroll
    for (int u = 0; u < kLeafBatch; ++u)
      tr[u] = load_tri(tris, first + min(k + u, count - 1));
#pragma unroll
    for (int u = 0; u < kLeafBatch; ++u) {
      float t, b1, b2;
      if (k + u < count && tri_test(tr[u], r, best.t, t, b1, b2)) {
        best.t = t;
        best.tri = first + k + u;
        best.b1 = b1;
        best.b2 = b2;
        if (any_hit) return true;
      }
    }
  }
  return false;
}

__device__ __forceinline__ Ray ray_of_lane(const Ray& r, int src) {
  Ray s;
  s.ox = __shfl_sync(kFullMask, r.ox, src);
  s.oy = __shfl_sync(kFullMask, r.oy, src);
  s.oz = __shfl_sync(kFullMask, r.oz, src);
  s.dx = __shfl_sync(kFullMask, r.dx, src);
  s.dy = __shfl_sync(kFullMask, r.dy, src);
  s.dz = __shfl_sync(kFullMask, r.dz, src);
  s.inx = __shfl_sync(kFullMask, r.inx, src);
  s.iny = __shfl_sync(kFullMask, r.iny, src);
  s.inz = __shfl_sync(kFullMask, r.inz, src);
  s.mint = __shfl_sync(kFullMask, r.mint, src);
  return s;
}

// a float's bits as an unsigned key of the same order (-0 counts as +0)
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned bits = __float_as_uint(t + 0.0f);
  return bits ^ ((bits >> 31) != 0 ? 0xffffffffu : 0x80000000u);
}

// The same leaf tests, but the whole warp works on one ray's leaf at a
// time: all 32 lanes call this together, `pending` is the ballot of lanes
// that have a leaf (first, count) to test, and for each such lane in turn
// lane l tests triangle l of its leaf (the next 32 in a further round).
// The sequential accept rule is kept by a reduction: of the accepted
// triangles the least t wins and of equal t the highest index; an any-hit
// ray takes the lowest accepted index and is done (returns true for its
// lane). The next leaf's triangles are loaded before the current ones are
// tested. A warp whose few live rays sit in large leaves spends one
// triangle test per leaf here instead of up to `count` in a row.
__device__ __forceinline__ bool leaf_tests_warp(
    const float4* __restrict__ tris, unsigned pending, int first, int count,
    const Ray& r, int any_hit, Best& best) {
  const int lane = threadIdx.x & 31;
  bool done = false;
  int src = __ffs(pending) - 1;
  int f = __shfl_sync(kFullMask, first, src);
  int n = __shfl_sync(kFullMask, count, src);
  Tri tr = load_tri(tris, f + min(lane, n - 1));
  while (pending != 0) {
    pending &= pending - 1;
    const int cur = src, cur_f = f, cur_n = n;
    const Tri cur_tr = tr;
    if (pending != 0) {
      src = __ffs(pending) - 1;
      f = __shfl_sync(kFullMask, first, src);
      n = __shfl_sync(kFullMask, count, src);
      tr = load_tri(tris, f + min(lane, n - 1));
    }
    const Ray rs = ray_of_lane(r, cur);
    float t_best = __shfl_sync(kFullMask, best.t, cur);
    int w_tri = -1;
    float w_b1 = 0.0f, w_b2 = 0.0f;
    for (int base = 0; base < cur_n; base += 32) {
      const int k = base + lane;
      const Tri trk =
          base == 0 ? cur_tr : load_tri(tris, cur_f + min(k, cur_n - 1));
      float t, b1, b2;
      const bool ok = tri_test(trk, rs, t_best, t, b1, b2) && k < cur_n;
      const unsigned oks = __ballot_sync(kFullMask, ok);
      if (oks == 0) continue;
      int w;
      if (any_hit) {
        w = __ffs(oks) - 1;
      } else {
        const unsigned key = ok ? order_key(t) : 0xffffffffu;
        const unsigned least = __reduce_min_sync(kFullMask, key);
        w = 31 - __clz(__ballot_sync(kFullMask, ok && key == least));
      }
      t_best = __shfl_sync(kFullMask, t, w);
      w_b1 = __shfl_sync(kFullMask, b1, w);
      w_b2 = __shfl_sync(kFullMask, b2, w);
      w_tri = cur_f + base + w;
      if (any_hit) break;
    }
    if (lane == cur && w_tri >= 0) {
      best.t = t_best;
      best.tri = w_tri;
      best.b1 = w_b1;
      best.b2 = w_b2;
      done = any_hit != 0;
    }
  }
  return done;
}

// The same leaf tests by a group of kGroup lanes (a power of two, `gmask`
// its lanes in the warp, `c` this lane's place in it) that walk one ray
// together and all hold its state: kGroup triangles at a time, one a lane,
// the next kGroup loaded before the current ones are tested, and the same
// reduction as above. Returns true where an any-hit ray is done.
template <int kGroup>
__device__ __forceinline__ bool leaf_tests_group(
    const float4* __restrict__ tris, int first, int count, int c,
    unsigned gmask, const Ray& r, int any_hit, Best& best) {
  Tri tr = load_tri(tris, first + min(c, count - 1));
  for (int base = 0; base < count; base += kGroup) {
    const int k = base + c;
    const Tri cur = tr;
    if (base + kGroup < count)
      tr = load_tri(tris, first + min(k + kGroup, count - 1));
    float t, b1, b2;
    const bool ok = tri_test(cur, r, best.t, t, b1, b2) && k < count;
    const unsigned oks = __ballot_sync(gmask, ok) & gmask;
    if (oks == 0) continue;
    int w;  // the winner's lane in the warp
    if (any_hit) {
      w = __ffs(oks) - 1;
    } else {
      const unsigned key = ok ? order_key(t) : 0xffffffffu;
      const unsigned least = __reduce_min_sync(gmask, key);
      w = 31 - __clz(__ballot_sync(gmask, ok && key == least) & gmask);
    }
    best.t = __shfl_sync(gmask, t, w);
    best.b1 = __shfl_sync(gmask, b1, w);
    best.b2 = __shfl_sync(gmask, b2, w);
    best.tri = first + base + (w & (kGroup - 1));
    if (any_hit) return true;
  }
  return false;
}

// ---- persistent blocks -----------------------------------------------------

// The next 32 consecutive rays for this warp: lane 0 advances the launch's
// counter in device memory and broadcasts the first ray's index. All 32
// lanes call it together. The result does not depend on which warp takes
// which rays: every ray writes only its own outputs.
__device__ __forceinline__ int next_batch(int* counter) {
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(counter, 32);
  return __shfl_sync(kFullMask, base, 0);
}

// The next ray for a group of `width` lanes that walk one ray together:
// its first lane (c == 0) advances the counter by one and the group takes
// the index. Groups of a warp that call it converged share one atomic.
__device__ __forceinline__ int next_ray(int* counter, int c, unsigned gmask,
                                        int width) {
  int base = 0;
  if (c == 0) base = atomicAdd(counter, 1);
  return __shfl_sync(gmask, base, 0, width);
}

// ---- mbarrier and bulk copy (TMA) ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk asynchronous copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from device to shared memory; completion is counted on
// the mbarrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// A warp stages `bytes` contiguous bytes: lane l issues chunks l, l + 32, ...
__device__ __forceinline__ void stage_bytes(void* dst, const void* src,
                                            uint32_t bytes, uint64_t* bar) {
  for (uint32_t off = (threadIdx.x & 31) * kStageChunk; off < bytes;
       off += 32 * kStageChunk)
    bulk_copy(static_cast<char*>(dst) + off,
              static_cast<const char*>(src) + off,
              min(kStageChunk, bytes - off), bar);
}

// ---- the host's launch plan -------------------------------------------------

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory that
// stay resident on the current device at once. The occupancy query and the
// shared-memory opt-in run once per (device, smem) and are remembered.
template <typename Kernel>
struct LaunchPlan {
  int device = -1;
  size_t smem = 0;
  int resident = 0;

  cudaError_t blocks(Kernel kernel, int threads, size_t smem_bytes,
                     int* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != device || smem_bytes != smem || resident == 0) {
      if (smem_bytes > 48 * 1024) {  // above 48 KB only by opting in
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_bytes));
        if (err != cudaSuccess) return err;
      }
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, smem_bytes);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      device = dev;
      smem = smem_bytes;
      resident = per_sm * sms;
    }
    *out = resident;
    return cudaSuccess;
  }
};

// Shared memory one block may take on the current device when
// blocks_per_sm blocks are to share a multiprocessor.
inline cudaError_t smem_budget(int blocks_per_sm, int* out) {
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved,
                                 cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const int share = per_sm / blocks_per_sm - reserved;
  *out = share < optin ? share : optin;
  return cudaSuccess;
}

}  // namespace goblin
