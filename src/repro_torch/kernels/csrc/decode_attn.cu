// Single-query GQA decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py: decode_attn
// (body _kernel; pl.pallas_call). q (B, H, D) is viewed as (Hkv, G, D);
// scores are fp32 times D**-0.5; cache positions at or past valid_len[b]
// are masked as -1e30; the softmax keeps max, sum and accumulator in fp32
// and the output is acc / max(l, 1e-30). As in the Pallas body (and unlike
// the plain version) the probabilities stay fp32 in the PV product. With
// valid_len[b] <= 0 every score is -1e30, so the answer is the mean of V
// over all S positions, as on the TPU.
//
// What bounds it on an H100: every live K and V byte is read once for a
// handful of multiply-adds (G = 4 query heads per kv head on the main
// path), so the least time is the K+V bytes up to valid_len over 3.35 TB/s,
// a few microseconds at decode. What keeps a kernel from it is latency:
// dependent rounds inside a block, and block-wide barriers between them.
//
// Design: one launch, grid (split, Hkv, B). The `split` blocks of a
// (b, kv head) row divide the row's live range [0, valid_len[b]) evenly,
// so no block works on masked positions and every row is balanced. Each
// block carries a fixed chain of dependent steps (fill level, copies,
// merges, ticket), so the wrapper picks few, large blocks: at most one
// per SM, 256 threads each (split = 2 at the main path's 64 rows). Each
// block:
//   - copies its K and V positions into shared memory with 16-byte
//     cp.async (tiles of `tile` positions, the next tile in flight while
//     this one is used), all of a tile's copies issued before any wait;
//   - runs a fused online softmax per warp: lpp lanes take one position at
//     16 bytes each, two positions per lane per step (64 / lpp per warp
//     step), the G query heads of the kv head in registers; the scores'
//     shuffle trees, the max, the exponentials (base 2: one ex2 each) and
//     the P.V update run for the G heads side by side, and each lane keeps
//     (m, l) and its 16 bytes of acc for every head. No block barrier
//     separates scores, softmax and P.V;
//   - merges its warps in shared memory into one partial (m, l, acc[G][D])
//     and writes it to a small fp32 workspace (L2-resident: 0.27 MB at the
//     main path's shape).
// The last block of a row to finish (a ticket: __threadfence, then
// atomicAdd on the row's counter) loads the row's (m, l) pairs once into
// shared memory, turns them into weights, merges the partials, writes the
// output and resets the counter to 0 for the next launch. A first design,
// a cluster of 8 blocks per row combining through distributed shared
// memory, measured slower at the main path's shape (PERF.md).

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_u32;
using repro::store_f;

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_SPLIT = 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e30f * LOG2E;  // the reference's mask value, base 2

// 16 bytes as fp32: 8 bf16 or 4 float values.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// 2^(x - m) that is 0 for an empty partial (m = -inf) instead of NaN.
// Scores are kept in base 2 (times log2 e), so each exponential is one
// ex2 instruction.
__device__ __forceinline__ float weight(float x, float m) {
  return x == -INFINITY ? 0.f : exp2f(x - m);
}

// K and V at element `off` of the shared tiles (a lane's 16 bytes of one
// position) as fp32, zeros where !live; K is left at zero unless want_k.
template <typename T, int VEC>
__device__ __forceinline__ void load16(const T* ks, const T* vs, int off, bool live,
                                       bool want_k, float (&kf)[VEC], float (&vf)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) kf[j] = vf[j] = 0.f;
  if (live) {
    if (want_k) unpack(*reinterpret_cast<const uint4*>(ks + off), kf);
    unpack(*reinterpret_cast<const uint4*>(vs + off), vf);
  }
}

// Shared memory: the K/V tiles, then the warps' partials m [NW][G],
// l [NW][G], acc [NW][G][D], then the final merge's m and l of the row's
// split partials, [split][G] each. kernels/decode_attn.py:geometry computes the
// same bytes. The workspace holds, per row and block, acc [G][D], m [G],
// l [G].
__host__ __device__ inline size_t smem_bytes(int G, int D, int tile, int nbuf, int elem,
                                             int split) {
  return (size_t)nbuf * 2 * tile * D * elem + 4 * ((size_t)NW * G * (D + 2) + 2 * split * G);
}

template <typename T, int GMAX>
__global__ void __launch_bounds__(NT)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ valid_len, T* __restrict__ out,
            float* __restrict__ work, int* __restrict__ tickets, int H, int Hkv, int S,
            int D, int lpp, int tile, int nbuf, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int split = gridDim.x, rank = blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int row = b * Hkv + kvh;
  const int G = H / Hkv;
  const int nch = D / VEC;   // 16-byte chunks of a position (<= lpp)
  const int ppw = 32 / lpp;  // positions per warp step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = lane & (lpp - 1);  // this lane's chunk of D
  const int sub = lane / lpp;       // this lane's position in a warp step
  const bool has_ch = ch < nch;
  const float scale2 = scale * LOG2E;  // scores in base 2

  // The block's share of the live range.
  const int vl = valid_len[b];
  const bool masked = vl <= 0;
  const int n = masked ? S : min(vl, S);
  const int share = (n + split - 1) / split;
  const int lo = min(n, rank * share), hi = min(n, lo + share);
  const int ntile = (hi - lo + tile - 1) / tile;

  extern __shared__ __align__(16) unsigned char smem[];
  T* kv = reinterpret_cast<T*>(smem);
  float* wm = reinterpret_cast<float*>(smem + (size_t)nbuf * 2 * tile * D * sizeof(T));
  float* wl = wm + NW * G;
  float* wacc = wl + NW * G;
  float* fm = wacc + (size_t)NW * G * D;  // final merge: [split][G] weights
  float* fl = fm + split * G;             // and [split][G] sums

  const size_t pos_stride = (size_t)Hkv * D;  // elements between positions
  const T* kb = k + ((size_t)b * S * Hkv + kvh) * D;
  const T* vb = v + ((size_t)b * S * Hkv + kvh) * D;
  // K and V of tile t into buffer t % nbuf, one commit group.
  auto issue = [&](int t) {
    T* dst = kv + (size_t)(t % nbuf) * 2 * tile * D;
    const int p0 = lo + t * tile, cnt = min(tile, hi - p0);
    for (int i = threadIdx.x; i < 2 * cnt * nch; i += NT) {
      const int which = i >= cnt * nch;
      const int j = i - which * cnt * nch;
      const int p = j / nch, c = j - p * nch;
      const T* src = which ? vb : kb;
      cp_async16(smem_u32(dst + ((size_t)which * tile + p) * D + c * VEC),
                 src + (size_t)(p0 + p) * pos_stride + c * VEC);
    }
    cp_async_commit();
  };
  for (int t = 0; t < min(ntile, nbuf); ++t) issue(t);

  float qf[GMAX][VEC], acc[GMAX][VEC], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G && has_ch) {
      unpack(__ldg(reinterpret_cast<const uint4*>(
                 q + ((size_t)b * H + (size_t)kvh * G + g) * D + ch * VEC)),
             qf[g]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) qf[g][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  for (int t = 0; t < ntile; ++t) {
    const int cnt = min(tile, hi - (lo + t * tile));
    if (t + 1 < ntile && nbuf > 1) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const T* ks = kv + (size_t)(t % nbuf) * 2 * tile * D;
    const T* vs = ks + (size_t)tile * D;

    // A warp step takes 2 * ppw positions: p0 = base + sub and p1 = p0 + ppw
    // for this lane, so the softmax bookkeeping is paid once per pair.
    for (int base = warp * 2 * ppw; base < cnt; base += NW * 2 * ppw) {
      const int p0 = base + sub, p1 = p0 + ppw;
      const bool ok0 = p0 < cnt, ok1 = p1 < cnt;  // base < cnt: sub 0's p0 is live
      float k0[VEC], k1[VEC], v0[VEC], v1[VEC];
      load16(ks, vs, p0 * D + ch * VEC, ok0 && has_ch, !masked, k0, v0);
      load16(ks, vs, p1 * D + ch * VEC, ok1 && has_ch, !masked, k1, v1);
      float s0[GMAX], s1[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        s0[g] = s1[g] = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s0[g] = fmaf(qf[g][j], k0[j], s0[g]);
          s1[g] = fmaf(qf[g][j], k1[j], s1[g]);
        }
      }
      // Sum over the lpp lanes of a position, all heads side by side.
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < lpp) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            s0[g] += __shfl_xor_sync(0xffffffffu, s0[g], o);
            s1[g] += __shfl_xor_sync(0xffffffffu, s1[g], o);
          }
        }
      float mx[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        s0[g] = ok0 ? (masked ? NEG2 : s0[g] * scale2) : -INFINITY;
        s1[g] = ok1 ? (masked ? NEG2 : s1[g] * scale2) : -INFINITY;
        mx[g] = fmaxf(s0[g], s1[g]);
      }
      // Max, then sum, over the step's positions (lanes lpp apart).
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o >= lpp) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
        }
      float pr0[GMAX], pr1[GMAX], ps[GMAX], corr[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float m_new = fmaxf(m[g], mx[g]);  // finite: sub 0's p0 is live
        corr[g] = exp2f(m[g] - m_new);            // 0 on the warp's first step
        pr0[g] = exp2f(s0[g] - m_new);            // 0 for a dead position
        pr1[g] = exp2f(s1[g] - m_new);
        ps[g] = pr0[g] + pr1[g];
        m[g] = m_new;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o >= lpp) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g) ps[g] += __shfl_xor_sync(0xffffffffu, ps[g], o);
        }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        l[g] = fmaf(l[g], corr[g], ps[g]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[g][j] = fmaf(pr1[g], v1[j], fmaf(pr0[g], v0[j], acc[g][j] * corr[g]));
      }
    }
    __syncthreads();
    if (t + nbuf < ntile) issue(t + nbuf);  // refill the buffer just freed
  }

  // The warp's acc: sum over its position lanes (one m for all of them).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o >= lpp) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
    }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
      if (sub == 0 && has_ch) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          wacc[((size_t)warp * G + g) * D + ch * VEC + j] = acc[g][j];
      }
    }
  }
  __syncthreads();

  // The block's partial, merged over its warps, into the workspace.
  const int rec = G * D + 2 * G;  // floats per partial
  float* mine = work + ((size_t)row * split + rank) * rec;
  for (int i = threadIdx.x; i < G * (D + 2); i += NT) {
    const int g = i < G * D ? i / D : (i - G * D) % G;
    float mb = -INFINITY;
    for (int w = 0; w < NW; ++w) mb = fmaxf(mb, wm[w * G + g]);
    float val = 0.f;
    if (i < G * D) {
      for (int w = 0; w < NW; ++w) val += weight(wm[w * G + g], mb) * wacc[(size_t)w * G * D + i];
    } else if (i < G * D + G) {
      val = mb;
    } else {
      for (int w = 0; w < NW; ++w) val += weight(wm[w * G + g], mb) * wl[w * G + g];
    }
    mine[i] = val;
  }

  // Ticket: the row's last block to get here merges every partial.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[row], 1) == split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Each partial's weight 2^(m_r - M) / max(L, 1e-30) per head, from its
  // (m, l) loaded once, in parallel, into shared memory.
  const float* rowp = work + (size_t)row * split * rec;
  for (int j = threadIdx.x; j < split * G; j += NT) {
    const float* pr = rowp + (size_t)(j / G) * rec + G * D + j % G;
    fm[j] = __ldcg(pr);
    fl[j] = __ldcg(pr + G);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += NT) {
    float mf = -INFINITY, lf = 0.f;
    for (int r = 0; r < split; ++r) mf = fmaxf(mf, fm[r * G + g]);
    for (int r = 0; r < split; ++r) lf = fmaf(weight(fm[r * G + g], mf), fl[r * G + g], lf);
    const float inv = 1.f / fmaxf(lf, 1e-30f);
    for (int r = 0; r < split; ++r) fm[r * G + g] = weight(fm[r * G + g], mf) * inv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NT) {
    const int g = i / D;
    float af = 0.f;
#pragma unroll 8
    for (int r = 0; r < split; ++r) af = fmaf(fm[r * G + g], __ldcg(rowp + (size_t)r * rec + i), af);
    store_f(out + ((size_t)b * H + (size_t)kvh * G) * D + i, af);
  }
  if (threadIdx.x == 0) tickets[row] = 0;  // ready for the next launch
}

template <typename T, int GMAX>
int launch(const void* q, const void* k, const void* v, const int* vl, void* out,
           float* work, int* tickets, int B, int H, int Hkv, int S, int D, int lpp,
           int split, int tile, int nbuf, size_t smem, float scale, cudaStream_t st) {
  auto kern = attn_kernel<T, GMAX>;
  static int smem_set = 48 * 1024;  // this instantiation's opt-in so far
  if ((int)smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = (int)smem;
  }
  kern<<<dim3(split, Hkv, B), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), vl,
      static_cast<T*>(out), work, tickets, H, Hkv, S, D, lpp, tile, nbuf, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_g(int G, const void* q, const void* k, const void* v, const int* vl, void* out,
             float* work, int* tickets, int B, int H, int Hkv, int S, int D, int lpp,
             int split, int tile, int nbuf, size_t smem, float scale, cudaStream_t st) {
#define REPRO_LAUNCH(GM)                                                                  \
  return launch<T, GM>(q, k, v, vl, out, work, tickets, B, H, Hkv, S, D, lpp, split, tile, \
                       nbuf, smem, scale, st)
  if (G <= 1) REPRO_LAUNCH(1);
  if (G <= 2) REPRO_LAUNCH(2);
  if (G <= 4) REPRO_LAUNCH(4);
  REPRO_LAUNCH(8);
#undef REPRO_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Geometry from the wrapper
// (kernels/decode_attn.py:geometry): `split` blocks per (b, kv head),
// `lpp` lanes per position, tiles of `tile` positions in `nbuf` buffers,
// `smem` dynamic shared-memory bytes. work: fp32 workspace of
// B * Hkv * split * (G * D + 2 * G); tickets: B * Hkv ints, all 0 before
// the launch and left 0 by it. Returns the launch's cudaError_t
// (0 = launched), or cudaErrorInvalidValue if the geometry is not one the
// kernel takes.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* valid_len, void* out, void* work,
                                  void* tickets, int B, int H, int Hkv, int S, int D,
                                  int split, int lpp, int tile, int nbuf, long long smem,
                                  float scale, int dtype, void* stream) {
  const int elem = dtype == 1 ? 2 : 4;
  const int G = Hkv > 0 ? H / Hkv : 0;
  const int nch = D * elem / 16;
  const bool ok = G >= 1 && G <= 8 && H % Hkv == 0 && D * elem % 16 == 0 && nch <= lpp &&
                  lpp <= 32 && (lpp & (lpp - 1)) == 0 && split >= 1 &&
                  split <= MAX_SPLIT && tile >= 1 && (nbuf == 1 || nbuf == 2) &&
                  smem == (long long)smem_bytes(G, D, tile, nbuf, elem, split);
  if (!ok) return cudaErrorInvalidValue;
  const int* vl = static_cast<const int*>(valid_len);
  float* w = static_cast<float*>(work);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_g<__nv_bfloat16>(G, q, k, v, vl, out, w, tk, B, H, Hkv, S, D, lpp, split,
                                   tile, nbuf, (size_t)smem, scale, st);
  return launch_g<float>(G, q, k, v, vl, out, w, tk, B, H, Hkv, S, D, lpp, split, tile, nbuf,
                         (size_t)smem, scale, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
