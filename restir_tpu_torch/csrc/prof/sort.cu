// Ray order for the walks: a 32-bit coherence key, an LSD radix sort of
// the keys written by hand, and the permuted gather of a [C, R] pack, with
// a plain copy of the pack as the gather's floor.
//
// Replaces the TPU probes prof/prof_take.py (the payload gather of the
// 9-channel rp pack by the wavefront permutation, and `_pin` at :140, an
// identity copy of that pack through VMEM) and prof/prof_wavefront.py
// (`jnp.argsort` of a coherence key, then the payload gather). Plain
// twins (restir_tpu_torch/prof/kernels.py): the torch key, torch.sort
// (stable=True) and index_select; the sort's permutation and the gather
// equal them bit for bit.
//
// Bound: bytes. The key reads two points and a flag per ray and writes 4
// bytes; the sort reads its keys and writes the sorted keys and the
// permutation once (each pass moves them again: 4 passes of 8 bits, so
// about 4 x (4 + 4 + 8 + 8) bytes a key; the scatter's writes land in
// 256 runs per block); the gather reads C floats at permuted columns and
// writes C floats in order.
//
// The sort: per pass, (1) each block of 256 threads counts the digits of
// its tile of 4096 keys (each warp its own 512, held in registers and
// loaded before any is used; the leader of each group of equal digits
// adds its size, __match_any_sync: no atomics, so a run of equal digits
// costs no contention); (2) 256 blocks scan the blocks' counts of one
// digit each, one block the digits' totals; (3) each block counts again
// per warp, places its keys digit by digit in shared memory (each
// warp's keys in order, a key's place its digit's next place plus its
// rank among equal digits in the round: stable, as
// torch.sort(stable=True)) and writes the tile out in runs of equal
// digits. A first design (one block scanning all counts, each thread a
// strided run; rounds under __syncthreads) took 0.81 ms for 2.07 M keys;
// warp-owned tiles writing one scattered word a key 0.19-0.26 ms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 16;  // a warp's rounds of 32 keys
constexpr int kRadix = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kDead = 0x7FFFFFFFu;  // the key of a lane not cast

// ---- the coherence key ---------------------------------------------------

// floor(((p - lo) / (hi - lo)) clamped to [0, 1 - 2^-24) x 2^bits), the
// twin's float32 ops one by one (no product is contracted here).
__device__ __forceinline__ uint32_t cell(float p, float lo, float ext,
                                         int bits) {
  float u = __fdiv_rn(__fsub_rn(p, lo), ext);
  if (!(u >= 0.0f)) u = 0.0f;  // NaN too
  u = fminf(u, 0.99999994f);
  return (uint32_t)__float2int_rz(__fmul_rn(u, (float)(1 << bits)));
}

__device__ __forceinline__ uint32_t morton(float x, float y, float z,
                                           const float* lo,
                                           const float* ext, int bits) {
  const uint32_t q[3] = {cell(x, lo[0], ext[0], bits),
                         cell(y, lo[1], ext[1], bits),
                         cell(z, lo[2], ext[2], bits)};
  uint32_t code = 0;
  for (int b = 0; b < bits; ++b)
    for (int a = 0; a < 3; ++a) code |= ((q[a] >> b) & 1u) << (3 * b + a);
  return code;
}

// 4 bits an axis of the direction x -> y over its largest component.
__device__ __forceinline__ uint32_t direction(float sx, float sy, float sz) {
  const float m = fmaxf(fmaxf(fabsf(sx), fabsf(sy)), fmaxf(fabsf(sz), 1e-30f));
  const float s[3] = {sx, sy, sz};
  uint32_t code = 0;
  for (int a = 0; a < 3; ++a) {
    float u = __fmul_rn(__fadd_rn(__fdiv_rn(s[a], m), 1.0f), 0.5f);
    if (!(u >= 0.0f)) u = 0.0f;
    u = fminf(u, 0.99999994f);
    code = (code << 4) | (uint32_t)__float2int_rz(__fmul_rn(u, 16.0f));
  }
  return code;
}

__global__ void __launch_bounds__(kThreads)
    key_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const uint8_t* __restrict__ live, int r, float lox,
               float loy, float loz, float hix, float hiy, float hiz,
               int order, uint32_t* __restrict__ key) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= r) return;
  if (!live[i]) {
    key[i] = kDead;
    return;
  }
  const float lo[3] = {lox, loy, loz};
  const float ext[3] = {__fsub_rn(hix, lox), __fsub_rn(hiy, loy),
                        __fsub_rn(hiz, loz)};
  const float px = x[3 * i], py = x[3 * i + 1], pz = x[3 * i + 2];
  const float tx = y[3 * i], ty = y[3 * i + 1], tz = y[3 * i + 2];
  uint32_t k;
  if (order == 0) {  // origin: Morton code, 10 bits an axis
    k = morton(px, py, pz, lo, ext, 10);
  } else if (order == 1) {  // target cell (3 bits an axis), then origin (7)
    k = (morton(tx, ty, tz, lo, ext, 3) << 21) | morton(px, py, pz, lo, ext, 7);
  } else {  // direction (4 bits an axis), then origin (6)
    k = (direction(__fsub_rn(tx, px), __fsub_rn(ty, py), __fsub_rn(tz, pz))
         << 18) |
        morton(px, py, pz, lo, ext, 6);
  }
  key[i] = k;
}

// ---- the radix sort --------------------------------------------------------

// A block's tile: each of its 8 warps owns kWarpKeys consecutive keys,
// which each lane holds in registers (kRounds of them: its key in each
// round of 32), loaded before any is used so the loads overlap.
constexpr int kWarpKeys = 32 * kRounds;            // 512
constexpr int kSortTile = kWarps * kWarpKeys;      // 4096 keys a block

// The lane's key of each round (kRadix's digit where the key is past r).
__device__ __forceinline__ void load_keys(const uint32_t* __restrict__ kin,
                                          int r, int base,
                                          uint32_t (&key)[kRounds]) {
  const int first = base + (threadIdx.x >> 5) * kWarpKeys + (threadIdx.x & 31);
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int k = first + 32 * i;
    key[i] = k < r ? __ldg(kin + k) : 0u;
  }
}

__device__ __forceinline__ int digit(uint32_t key, int k, int r,
                                     int shift) {
  return k < r ? (int)((key >> shift) & (kRadix - 1)) : kRadix;
}

// Each warp counts the digits of its keys into its own row of `cnt`
// (leaders of equal digits add their group's size: no atomics).
__device__ __forceinline__ void warp_counts(const uint32_t (&key)[kRounds],
                                            int r, int shift, int base,
                                            int (*cnt)[kRadix]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int first = base + warp * kWarpKeys + lane;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int dg = digit(key[i], first + 32 * i, r, shift);
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (dg < kRadix && (peers & below) == 0)
      cnt[warp][dg] += __popc(peers);
    __syncwarp();
  }
}

// hist [nb][256]: each block's digit counts (block-major).
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint32_t* __restrict__ keys, int r, int shift,
                int* __restrict__ hist) {
  __shared__ int cnt[kWarps][kRadix];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt[w][threadIdx.x] = 0;
  uint32_t key[kRounds];
  load_keys(keys, r, blockIdx.x * kSortTile, key);
  __syncthreads();
  warp_counts(key, r, shift, blockIdx.x * kSortTile, cnt);
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += cnt[w][threadIdx.x];
  hist[blockIdx.x * kRadix + threadIdx.x] = sum;
}

// Block d: the exclusive prefix over blocks of digit d's counts, in
// place, and the digit's total (nb <= 1024).
__global__ void __launch_bounds__(1024)
    column_scan_kernel(int* __restrict__ hist, int nb,
                       int* __restrict__ total) {
  __shared__ int s[1024];
  const int t = threadIdx.x, d = blockIdx.x;
  const int v = t < nb ? hist[t * kRadix + d] : 0;
  s[t] = v;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int u = t >= off ? s[t - off] : 0;
    __syncthreads();
    s[t] += u;
    __syncthreads();
  }
  if (t < nb) hist[t * kRadix + d] = s[t] - v;
  if (t == 1023) total[d] = s[t];
}

// base[d]: the exclusive prefix of the digits' totals (one block of 256).
__global__ void __launch_bounds__(kRadix)
    base_kernel(const int* __restrict__ total, int* __restrict__ base) {
  __shared__ int s[kRadix];
  const int t = threadIdx.x;
  const int v = total[t];
  s[t] = v;
  __syncthreads();
  for (int off = 1; off < kRadix; off <<= 1) {
    const int u = t >= off ? s[t - off] : 0;
    __syncthreads();
    s[t] += u;
    __syncthreads();
  }
  base[t] = s[t] - v;
}

// Each warp counts its keys' digits; the block turns the counts into
// each digit's start in the block's tile (digits in order) and each
// warp's first place within its digit's run; each warp then puts its
// keys, in order, at their places in shared memory (a key's place its
// digit's next place plus its rank among equal digits in the round:
// stable), and the block writes the sorted tile out run by run, so the
// global writes are runs of each digit, not one scattered word a key.
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const uint32_t* __restrict__ kin,
                   const int* __restrict__ vin, uint32_t* __restrict__ kout,
                   int* __restrict__ vout, int r, int shift,
                   const int* __restrict__ hist,
                   const int* __restrict__ base) {
  __shared__ int cnt[kWarps][kRadix];
  __shared__ int lstart[kRadix], gstart[kRadix];
  __shared__ uint32_t skey[kSortTile];
  __shared__ int sval[kSortTile];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt[w][t] = 0;
  __syncthreads();
  const int b0 = blockIdx.x * kSortTile;
  uint32_t key[kRounds];
  load_keys(kin, r, b0, key);
  int val[kRounds];
  const int first = b0 + warp * kWarpKeys + lane;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int k = first + 32 * i;
    val[i] = vin ? (k < r ? __ldg(vin + k) : 0) : k;
  }
  warp_counts(key, r, shift, b0, cnt);
  __syncthreads();
  // thread t = digit t: its block total, then the digits' exclusive scan
  int tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += cnt[w][t];
  lstart[t] = tot;
  __syncthreads();
  for (int off = 1; off < kRadix; off <<= 1) {
    const int u = t >= off ? lstart[t - off] : 0;
    __syncthreads();
    lstart[t] += u;
    __syncthreads();
  }
  const int l0 = lstart[t] - tot;
  __syncthreads();
  lstart[t] = l0;
  gstart[t] = base[t] + hist[blockIdx.x * kRadix + t];
  int run = l0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = cnt[w][t];
    cnt[w][t] = run;
    run += c;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int dg = digit(key[i], first + 32 * i, r, shift);
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (dg < kRadix) {
      const int at = cnt[warp][dg] + __popc(peers & below);
      skey[at] = key[i];
      sval[at] = val[i];
    }
    __syncwarp();
    if (dg < kRadix && (peers & below) == 0) cnt[warp][dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int n = min(kSortTile, r - b0);
  for (int j = t; j < n; j += kThreads) {
    const uint32_t k = skey[j];
    const int d = (int)((k >> shift) & (kRadix - 1));
    const int dst = gstart[d] + (j - lstart[d]);
    kout[dst] = k;
    vout[dst] = sval[j];
  }
}

// ---- the gather and its floor ----------------------------------------------

// One thread a (channel, column): a channel's reads of a block are
// independent of the other channels', so a lane has one load in flight
// where a loop over channels had C in turn.
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const float* __restrict__ src, const int* __restrict__ perm,
                  float* __restrict__ dst, int r) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= r) return;
  const size_t ch = blockIdx.y;
  dst[ch * r + i] = __ldg(src + ch * r + (size_t)__ldg(perm + i));
}

__global__ void __launch_bounds__(kThreads)
    copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                size_t n4) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * kThreads)
    dst[i] = __ldg(src + i);
}

}  // namespace

// key uint32 [r]: the coherence key of segment x -> y (float32 [r, 3]
// each) in the box lo..hi; order 0 origin, 1 target cell then origin, 2
// direction then origin (the orders of walk_ab.py, cut to 30 bits); lanes
// with live 0 get 0x7FFFFFFF (last).
extern "C" int restir_prof_key(const float* x, const float* y,
                               const uint8_t* live, int r, float lox,
                               float loy, float loz, float hix, float hiy,
                               float hiz, int order, uint32_t* key,
                               void* stream) {
  if (r <= 0 || order < 0 || order > 2) return (int)cudaErrorInvalidValue;
  key_kernel<<<(r + kThreads - 1) / kThreads, kThreads, 0,
               (cudaStream_t)stream>>>(x, y, live, r, lox, loy, loz, hix,
                                       hiy, hiz, order, key);
  return (int)cudaGetLastError();
}

// Blocks of the sort's passes for r keys; its scratch `hist` holds
// (blocks + 2) x 256 ints.
extern "C" int restir_prof_sort_blocks(int r) {
  return (r + kSortTile - 1) / kSortTile;
}

// Sort keys [r] (not modified) into keys_a with the permutation in vals_a
// (keys_b / vals_b: scratch of r each): 4 passes of 8 bits, stable.
extern "C" int restir_prof_radix_sort(const uint32_t* keys, uint32_t* keys_a,
                                      int* vals_a, uint32_t* keys_b,
                                      int* vals_b, int* hist, int r,
                                      void* stream) {
  const int nb = restir_prof_sort_blocks(r);
  if (r <= 0 || nb > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int* total = hist + nb * kRadix;
  int* base = total + kRadix;
  const uint32_t* kin = keys;
  const int* vin = nullptr;
  for (int pass = 0; pass < 4; ++pass) {
    uint32_t* kout = pass % 2 == 0 ? keys_b : keys_a;
    int* vout = pass % 2 == 0 ? vals_b : vals_a;
    const int shift = 8 * pass;
    hist_kernel<<<nb, kThreads, 0, st>>>(kin, r, shift, hist);
    column_scan_kernel<<<kRadix, 1024, 0, st>>>(hist, nb, total);
    base_kernel<<<1, kRadix, 0, st>>>(total, base);
    scatter_kernel<<<nb, kThreads, 0, st>>>(kin, vin, kout, vout, r, shift,
                                            hist, base);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    kin = kout;
    vin = vout;
  }
  return (int)cudaSuccess;
}

// dst [c, r] = src[:, perm] (src [c, r], perm int32 [r]).
extern "C" int restir_prof_gather(const float* src, const int* perm,
                                  float* dst, int c, int r, void* stream) {
  if (r <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((r + kThreads - 1) / kThreads, c);
  gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(src, perm, dst,
                                                            r);
  return (int)cudaGetLastError();
}

// dst = src, n floats (n % 4 == 0, 16-byte aligned).
extern "C" int restir_prof_copy(const float* src, float* dst, long long n,
                                void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)n / 4;
  const size_t want = (n4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  copy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst),
      n4);
  return (int)cudaGetLastError();
}
