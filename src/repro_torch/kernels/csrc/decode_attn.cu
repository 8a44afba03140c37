// Single-query GQA decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py: decode_attn
// (body _kernel; pl.pallas_call). q (B, H, D) is viewed as (Hkv, G, D);
// scores are fp32 times D**-0.5; cache positions at or past valid_len[b]
// are masked; the softmax keeps max, sum and accumulator in fp32 and the
// output is acc / max(l, 1e-30). As in the Pallas body (and unlike the
// plain version) the probabilities stay fp32 in the PV product.
//
// What bounds it on an H100: every live K and V byte is read once for a
// handful of multiply-adds (G = 4 query heads per kv head on the main
// path), so the least time is the K+V bytes up to valid_len over 3.35 TB/s.
//
// Design: the TPU walks S in order inside one grid row, which here would
// give B*Hkv = 64 blocks, too few for 132 SMs. This is split-S
// flash-decoding in two launches:
//   1. grid (S/L, Hkv, B): each block takes one L-long chunk of one kv
//      head, computes the G heads' scores (one warp per cache position,
//      lanes across D), their chunk max m and sum l, and the unnormalised
//      P.V, and writes fp32 partials (m, l, acc);
//   2. grid (H, B): rescales the partials by exp(m_i - M) and divides.
// A chunk that lies wholly at or past valid_len reads no K/V and writes
// (m, l, acc) = (-1e30, 0, 0), which the combine weighs by exactly 0 as
// long as some chunk of the row is live, i.e. valid_len >= 1. That always
// holds at decode (valid = min(len + 1, cap)). With valid_len = 0 this
// kernel returns zeros where the TPU kernel averages V. Inside a live chunk
// the masked tail is simply not visited: exp(-1e30 - m) is exactly 0 in
// fp32, so that equals the reference's -1e30 fill.

#include "common.cuh"

namespace {

using repro::store_f;
using repro::to_f;
using repro::warp_max;
using repro::warp_sum;

constexpr int NT = 128;    // threads per block
constexpr int MAX_DJ = 8;  // D / 32 <= 8, i.e. head_dim <= 256

template <typename T>
__global__ void __launch_bounds__(NT)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ valid_len,
             float* __restrict__ m_part, float* __restrict__ l_part,
             float* __restrict__ acc_part, int H, int Hkv, int S, int D,
             int L, float scale) {
  const int s_idx = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = H / Hkv;
  const int start = s_idx * L;
  const int stop = min(min(start + L, S), valid_len[b]);
  // Partial slot of query head kvh*G + g.
  const size_t p0 = ((size_t)b * H + (size_t)kvh * G) * n_split + s_idx;

  if (stop <= start) {  // chunk wholly masked: no K/V reads
    for (int i = threadIdx.x; i < G * D; i += NT)
      acc_part[(p0 + (size_t)(i / D) * n_split) * D + i % D] = 0.f;
    for (int g = threadIdx.x; g < G; g += NT) {
      m_part[p0 + (size_t)g * n_split] = -1e30f;
      l_part[p0 + (size_t)g * n_split] = 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;          // [G][D] queries in fp32
  float* sc = smem + G * D;  // [G][L] scores, then probabilities
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = stop - start;
  const int dj = D / 32;

  for (int i = threadIdx.x; i < G * D; i += NT)
    qs[i] = to_f(q[((size_t)b * H + (size_t)kvh * G) * D + i]);
  __syncthreads();

  for (int p = warp; p < n; p += NT / 32) {
    const T* krow = k + (((size_t)b * S + start + p) * Hkv + kvh) * D;
    float kr[MAX_DJ];
#pragma unroll
    for (int j = 0; j < MAX_DJ; ++j) kr[j] = j < dj ? to_f(krow[lane + 32 * j]) : 0.f;
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_DJ; ++j)
        if (j < dj) dot = fmaf(qs[g * D + lane + 32 * j], kr[j], dot);
      dot = warp_sum(dot);
      if (lane == 0) sc[g * L + p] = dot * scale;
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += NT / 32) {
    float mx = -1e30f;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, sc[g * L + p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float e = expf(sc[g * L + p] - mx);
      sc[g * L + p] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_part[p0 + (size_t)g * n_split] = mx;
      l_part[p0 + (size_t)g * n_split] = sum;
    }
  }
  __syncthreads();

  // acc[g][dd] = sum_p prob[g][p] * v[p][dd], four heads per pass so each
  // V element is read once per four query heads.
  for (int g0 = 0; g0 < G; g0 += 4) {
    for (int dd = threadIdx.x; dd < D; dd += NT) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < n; ++p) {
        const float vv = to_f(v[(((size_t)b * S + start + p) * Hkv + kvh) * D + dd]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (g0 + j < G) acc[j] = fmaf(sc[(g0 + j) * L + p], vv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g0 + j < G) acc_part[(p0 + (size_t)(g0 + j) * n_split) * D + dd] = acc[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
               const float* __restrict__ acc_part, T* __restrict__ out, int H,
               int D, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * H + h) * n_split;
  float mx = -1e30f;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_part[base + s]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) l += expf(m_part[base + s] - mx) * l_part[base + s];
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int dd = threadIdx.x; dd < D; dd += NT) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += expf(m_part[base + s] - mx) * acc_part[(base + s) * D + dd];
    store_f(out + ((size_t)b * H + h) * D + dd, a * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           float* m_part, float* l_part, float* acc_part, void* out, int B,
           int H, int Hkv, int S, int D, int L, float scale, cudaStream_t st) {
  const int n_split = (S + L - 1) / L;
  const int G = H / Hkv;
  const size_t smem = (size_t)(G * D + G * L) * sizeof(float);
  split_kernel<T><<<dim3(n_split, Hkv, B), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid_len, m_part, l_part, acc_part, H, Hkv, S,
      D, L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<dim3(H, B), NT, 0, st>>>(m_part, l_part, acc_part,
                                               static_cast<T*>(out), H, D, n_split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Partials are (B, H, ceil(S/L)) for m and
// l and (B, H, ceil(S/L), D) for acc, all fp32.
// Returns cudaGetLastError() after both launches (0 = launched).
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const void* valid_len, void* m_part,
                                  void* l_part, void* acc_part, void* out,
                                  int B, int H, int Hkv, int S, int D, int L,
                                  float scale, int dtype, void* stream) {
  const int* vl = static_cast<const int*>(valid_len);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  float* acc = static_cast<float*>(acc_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, vl, m, l, acc, out, B, H, Hkv, S, D, L, scale, st);
  return launch<float>(q, k, v, vl, m, l, acc, out, B, H, Hkv, S, D, L, scale, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
