// Grouped expert FFN of the MoE layer, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py: moe_gmm (body
// _kernel; pl.pallas_call). Per expert e over its capacity bucket
//
//     y[e] = (act(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]
//
// with fp32 accumulation, h cast to x's type before the down projection,
// act = silu (swiglu) or tanh-gelu (geglu), and every row at or past
// group_sizes[e] equal to zero (the plain version's row rule; on the MoE
// path it equals the TPU kernel's block rule because pad rows are zero).
//
// What bounds it on an H100: at decode a bucket holds C = 8 rows, so each
// weight byte feeds at most C multiply-adds, far below the ~295 operations
// per byte at which the card stops being memory bound. The least time is
// the LIVE experts' weights (3*d*F*2 B = 157 MB per expert at d = 4096,
// F = 6400, bf16) over 3.35 TB/s.
//
// Design: the TPU runs one fused kernel per (e, c-block), which at decode
// is 16 blocks, far too few for 132 SMs. Here it is two launches of one
// skinny grouped-GEMM template:
//   1. grid (F/64, C/8, E): h = act(x @ Wg) * (x @ Wu), stored as x's type
//      into an (E, C, F) scratch (1.6 MB at decode);
//   2. grid (d/64, C/8, E): y = h @ Wd.
// Each block owns 8 rows by 64 columns; its 8 warps split the reduction
// rows, each lane streams two neighbouring columns of every weight row
// (coalesced 128 B per warp and row), and the block reduces the warps'
// partial sums in shared memory. The block's activation rows are staged in
// shared memory in fp32, 256 reduction rows at a time. A block whose first
// row is at or past group_sizes[e] reads no weights at all: launch 1
// returns at once (its h rows are never read) and launch 2 writes zeros.
// So only the live experts' weights cross the memory bus. Plain FMA, no
// tensor cores: wgmma/TMA and a fused split-F version are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro::load2;
using repro::store_f;
using repro::to_f;

constexpr int TC = 8;    // bucket rows per block
constexpr int TN = 64;   // output columns per block: 32 lanes x 2
constexpr int NW = 8;    // warps per block, splitting the reduction rows
constexpr int KC = 256;  // reduction rows staged in shared memory at once

__device__ __forceinline__ float act_apply(float g, int act) {
  if (act == 1) {  // tanh-approximated gelu, jax.nn.gelu's default
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(k0 * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + expf(-g));  // silu
}

// GATED:  out[e][c][n] = act(a[e][c] . w0[e][:, n]) * (a[e][c] . w1[e][:, n])
// !GATED: out[e][c][n] = c < gs[e] ? a[e][c] . w0[e][:, n] : 0
// a: (E, C, K); w0/w1: (E, K, N); out: (E, C, N); N even.
template <typename T, bool GATED>
__global__ void __launch_bounds__(32 * NW)
grouped_rows_kernel(const T* __restrict__ a, const T* __restrict__ w0,
                    const T* __restrict__ w1, const int* __restrict__ gs,
                    T* __restrict__ out, int C, int K, int N, int act) {
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * TC;
  const int n0 = blockIdx.x * TN;
  const int live = gs[e];
  const int rows = min(TC, C - c0);

  if (c0 >= live) {  // dead block: read no weights
    if constexpr (!GATED) {
      for (int i = threadIdx.x; i < TC * TN; i += 32 * NW) {
        const int c = i / TN, col = n0 + i % TN;
        if (c < rows && col < N) store_f(out + ((size_t)e * C + c0 + c) * N + col, 0.f);
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = n0 + 2 * lane;
  const bool col_ok = n < N;
  const T* arow = a + ((size_t)e * C + c0) * K;
  const T* w0e = w0 + (size_t)e * K * N;
  const T* w1e = GATED ? w1 + (size_t)e * K * N : nullptr;

  __shared__ __align__(16) float xs[KC][TC];
  __shared__ float red[GATED ? 2 : 1][NW][TC][TN];

  float acc0[TC][2], acc1[TC][2];
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    acc0[c][0] = acc0[c][1] = 0.f;
    acc1[c][0] = acc1[c][1] = 0.f;
  }

  for (int kb = 0; kb < K; kb += KC) {
    const int kn = min(KC, K - kb);
    for (int i = threadIdx.x; i < KC * TC; i += 32 * NW) {
      const int c = i / KC, kk = i % KC;
      xs[kk][c] = (c < rows && kk < kn) ? to_f(arow[(size_t)c * K + kb + kk]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll 4
      for (int kk = warp; kk < kn; kk += NW) {
        const size_t off = (size_t)(kb + kk) * N + n;
        const float2 g = load2(w0e + off);
        float2 u = make_float2(0.f, 0.f);
        if constexpr (GATED) u = load2(w1e + off);
        const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
        const float xv[TC] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          acc0[c][0] = fmaf(xv[c], g.x, acc0[c][0]);
          acc0[c][1] = fmaf(xv[c], g.y, acc0[c][1]);
          if constexpr (GATED) {
            acc1[c][0] = fmaf(xv[c], u.x, acc1[c][0]);
            acc1[c][1] = fmaf(xv[c], u.y, acc1[c][1]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < TC; ++c) {
    red[0][warp][c][2 * lane] = acc0[c][0];
    red[0][warp][c][2 * lane + 1] = acc0[c][1];
    if constexpr (GATED) {
      red[GATED ? 1 : 0][warp][c][2 * lane] = acc1[c][0];
      red[GATED ? 1 : 0][warp][c][2 * lane + 1] = acc1[c][1];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TC * TN; i += 32 * NW) {
    const int c = i / TN, j = i % TN;
    const int row = c0 + c, col = n0 + j;
    if (c >= rows || col >= N) continue;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s0 += red[0][w][c][j];
      if constexpr (GATED) s1 += red[GATED ? 1 : 0][w][c][j];
    }
    float val;
    if constexpr (GATED) {
      val = act_apply(s0, act) * s1;
    } else {
      val = row < live ? s0 : 0.f;
    }
    store_f(out + ((size_t)e * C + row) * N + col, val);
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const int* gs, void* h, void* y, int E, int C, int d, int F,
           int act, cudaStream_t stream) {
  const dim3 block(32 * NW);
  const dim3 grid_up((F + TN - 1) / TN, (C + TC - 1) / TC, E);
  grouped_rows_kernel<T, true><<<grid_up, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), gs, static_cast<T*>(h), C, d, F, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down((d + TN - 1) / TN, (C + TC - 1) / TC, E);
  grouped_rows_kernel<T, false><<<grid_down, block, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd), nullptr, gs,
      static_cast<T*>(y), C, F, d, 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 = swiglu, 1 = geglu.
// Returns cudaGetLastError() after both launches (0 = launched).
extern "C" int moe_gmm_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, const void* group_sizes, void* h,
                              void* y, int E, int C, int d, int F, int act,
                              int dtype, void* stream) {
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wg, wu, wd, gs, h, y, E, C, d, F, act, st);
  return launch<float>(x, wg, wu, wd, gs, h, y, E, C, d, F, act, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
