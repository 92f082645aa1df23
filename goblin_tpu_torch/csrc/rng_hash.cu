// The sample hash, core/rng.py::hash_uniform, as one kernel a call.
//
// It replaces no Pallas kernel. goblin_tpu/core/rng.py is jnp arithmetic
// that XLA fuses into the ops that consume it; PyTorch's eager mode runs
// each of the int64 form's 77 operations as a kernel of its own. What a
// call has to move is 4 B read (the pixel id) and 4 B written a lane, 0.16
// us at 65,536 lanes and 3.35 TB/s, so the launch itself bounds it. The
// design is one launch a call: one thread a lane over a grid-stride loop, no
// shared memory, and the coordinates known on the host folded there.
//
// Each of the five coordinates (seed, pixel, sample, bounce, dim) is either
// a scalar or a contiguous int32 or int64 array of the output's length. An
// int64 is read as its low 32 bits, which is what the int64 form's
// `& 0xFFFFFFFF` keeps. A scalar arrives with the arithmetic that involves
// it alone done on the host: the seed with its salt added, the bounce
// multiplied by its constant; where bounce and dim are both scalars, the
// bounce carries their whole key and the dim is 0. The arithmetic is
// uint32_t's, which wraps as the int64 form's masks do, so every value is
// the int64 form's bit for bit; the top 24 bits convert to float exactly and
// the scale is a power of two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSeedSalt = 0x1234567u;
constexpr uint32_t kBounceMul = 0x01000193u;
constexpr int kThreads = 256;
// a launch's most blocks: 16 resident blocks on each of 132 SMs; larger
// calls loop
constexpr int64_t kMaxBlocks = 132 * 16;

enum Kind : int { kScalar = 0, kInt32 = 1, kInt64 = 2 };

struct Coord {
  const void* array;
  uint32_t value;
  int kind;
};

__device__ __forceinline__ uint32_t coord(const Coord& c, int64_t i) {
  if (c.kind == kInt32)
    return static_cast<uint32_t>(static_cast<const int32_t*>(c.array)[i]);
  if (c.kind == kInt64)
    return static_cast<uint32_t>(static_cast<const int64_t*>(c.array)[i]);
  return c.value;
}

// 32-bit hash combine (xxhash-style avalanche), core/rng.py::_mix
__device__ __forceinline__ uint32_t mix(uint32_t a, uint32_t b) {
  uint32_t h = a * 0x9E3779B1u + b;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  h ^= h >> 13;
  h *= 0xC2B2AE3Du;
  return h ^ (h >> 16);
}

__global__ void __launch_bounds__(kThreads)
    hash_kernel(int64_t n, Coord seed, Coord pixel, Coord sample,
                Coord bounce, Coord dim, float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const uint32_t s =
        seed.kind == kScalar ? seed.value : coord(seed, i) + kSeedSalt;
    const uint32_t b =
        bounce.kind == kScalar ? bounce.value : coord(bounce, i) * kBounceMul;
    uint32_t h = mix(s, coord(pixel, i));
    h = mix(h, coord(sample, i));
    h = mix(h, b + coord(dim, i));
    out[i] = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
  }
}

}  // namespace

// out (n,) float32 <- the hash of the five coordinates, each given as
// (kind, array, value); launched on `stream`. Returns cudaGetLastError().
extern "C" int goblin_rng_hash(int64_t n, int seed_kind, const void* seed,
                               uint32_t seed_value, int pixel_kind,
                               const void* pixel, uint32_t pixel_value,
                               int sample_kind, const void* sample,
                               uint32_t sample_value, int bounce_kind,
                               const void* bounce, uint32_t bounce_value,
                               int dim_kind, const void* dim,
                               uint32_t dim_value, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      n, Coord{seed, seed_value, seed_kind},
      Coord{pixel, pixel_value, pixel_kind},
      Coord{sample, sample_value, sample_kind},
      Coord{bounce, bounce_value, bounce_kind},
      Coord{dim, dim_value, dim_kind}, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
