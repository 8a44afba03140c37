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
// What bounds it on an H100: a bucket holds C = 8 rows at decode and 16-48
// at a batch-1 prefill, so each weight byte feeds at most C multiply-adds,
// below the ~295 operations per byte at which the card stops being memory
// bound. The least time is the LIVE experts' weights (3*d*F*2 B = 157 MB
// per expert at d = 4096, F = 6400, bf16) over 3.35 TB/s, so each live
// weight byte has to be read once, with enough bytes in flight per SM.
//
// Design, bf16 (the serving path): two launches of one grouped kernel,
//   1. grid (F/64, C/64, E): h = act(x @ Wg) * (x @ Wu), stored as bf16
//      into an (E, C, F) scratch;
//   2. grid (d/64, C/64, E): y = h @ Wd.
// A and B are swapped against the usual GEMM: the weights are the M side
// (64 output features per block, 16 per warp) and the bucket's rows the N
// side (up to 64 rows, in 8-row n-blocks), so one block covers every live
// row of its bucket and each weight tile is read from device memory once.
// The products are tensor-core mma.sync.m16n8k16 (bf16 in, fp32 out); the
// weight tile (k rows x 64 features, features contiguous) is the A operand
// through ldmatrix.trans, the bucket rows (k contiguous) the B operand
// through ldmatrix. Tiles of 64 reduction rows arrive by 16-byte cp.async
// into a 4-stage ring (3 stages, 48 KB per gate/up block, in flight while
// one is multiplied), XOR-swizzled by 16-byte chunk so ldmatrix reads are
// free of bank conflicts. N-blocks without a live row are skipped; a block
// whose rows are all at or past group_sizes[e] reads no weights (launch 1
// returns at once, launch 2 writes zeros). Edges of C, d and F that do not
// fill a tile are zero-filled by the copies and masked at the store; d and
// F must be multiples of 8 (16-byte rows).
//
// Design, fp32: the same two launches as plain FMA over 8-row blocks (the
// tensor cores would need TF32, which breaks fp32 parity); 8 warps split
// the reduction and reduce through shared memory.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::load2;
using repro::smem_u32;

__device__ __forceinline__ float act_apply(float g, int act) {
  if (act == 1) {  // tanh-approximated gelu, jax.nn.gelu's default
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(k0 * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + expf(-g));  // silu
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int MM_BM = 64;      // output features per block (M side)
constexpr int MM_BK = 64;      // reduction rows per stage: 128 B per tile row
constexpr int MM_ROWS = 64;    // bucket rows per block (N side)
constexpr int MM_NB = MM_ROWS / 8;
constexpr int MM_STAGES = 4;
constexpr int MM_WARPS = MM_BM / 16;
constexpr int MM_THREADS = 32 * MM_WARPS;
constexpr int MM_TILE = MM_BK * MM_BM * 2;  // bytes of one weight tile

// Byte offset of 16-byte chunk `ch` (0..7) of row `r` in a tile of 128-byte
// rows, swizzled so that eight consecutive rows put a chunk column in eight
// different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * 128 + ((ch ^ (r & 7)) << 4));
}

// Stage bytes of the ring: the weight tile(s) and `rows_pad` bucket rows.
__host__ __device__ constexpr int mm_stage_bytes(bool gated, int rows_pad) {
  return (gated ? 2 : 1) * MM_TILE + rows_pad * MM_BK * 2;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// GATED:  out[e][c][m] = act(a[e][c] . w0[e][:, m]) * (a[e][c] . w1[e][:, m])
// !GATED: out[e][c][m] = c < live ? a[e][c] . w0[e][:, m] : 0
// a: (E, C, K); w0/w1: (E, K, M); out: (E, C, M); K, M multiples of 8.
template <bool GATED>
__global__ void __launch_bounds__(MM_THREADS)
mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w0,
           const bf16* __restrict__ w1, const int* __restrict__ gs,
           bf16* __restrict__ out, int C, int K, int M, int rows_pad, int act) {
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * MM_ROWS;  // first bucket row of the block
  const int m0 = blockIdx.x * MM_BM;    // first output feature
  const int live = min(max(gs[e], 0), C);
  const int nrow = min(MM_ROWS, C - r0);  // bucket rows the block owns
  const int nlive = min(nrow, live - r0); // of which live (<= 0: none)
  bf16* outb = out + ((size_t)e * C + r0) * M;
  const bf16 zero = __float2bfloat16(0.f);

  if (nlive <= 0) {  // dead block: read no weights
    if constexpr (!GATED) {
      for (int i = threadIdx.x; i < nrow * MM_BM; i += MM_THREADS) {
        const int m = m0 + i % MM_BM;
        if (m < M) outb[(size_t)(i / MM_BM) * M + m] = zero;
      }
    }
    return;
  }

  const int nb_live = (nlive + 7) / 8;  // n-blocks holding a live row
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  const int stage_bytes = mm_stage_bytes(GATED, rows_pad);
  const bf16* w0e = w0 + (size_t)e * K * M;
  const bf16* w1e = GATED ? w1 + (size_t)e * K * M : w0e;
  const bf16* ae = a + ((size_t)e * C + r0) * K;
  const int nk = (K + MM_BK - 1) / MM_BK;
  const int x_chunks = nb_live * 8 * (MM_BK / 8);

  auto load_stage = [&](int slot, int kt) {
    const uint32_t st = sbase + slot * stage_bytes;
    const int k0 = kt * MM_BK;
    for (int i = threadIdx.x; i < MM_BK * 8; i += MM_THREADS) {
      const int kr = i >> 3, ch = i & 7;
      const int k = k0 + kr, m = m0 + ch * 8;
      const bool ok = k < K && m < M;
      const size_t off = ok ? (size_t)k * M + m : 0;
      const uint32_t dst = st + swz(kr, ch);
      cp_async16(dst, w0e + off, ok);
      if constexpr (GATED) cp_async16(dst + MM_TILE, w1e + off, ok);
    }
    const uint32_t xs = st + (GATED ? 2 : 1) * MM_TILE;
    for (int i = threadIdx.x; i < x_chunks; i += MM_THREADS) {
      const int r = i >> 3, ch = i & 7;
      const int k = k0 + ch * 8;
      const bool ok = r < nrow && k < K;
      cp_async16(xs + swz(r, ch), ae + (ok ? (size_t)r * K + k : 0), ok);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc0[MM_NB][4], acc1[MM_NB][4];
#pragma unroll
  for (int nb = 0; nb < MM_NB; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[nb][j] = acc1[nb][j] = 0.f;

  // ldmatrix.x4.trans: lane supplies row (lane & 7) of 8x8 matrix lane >> 3;
  // matrices (k +0, m +0), (k +0, m +8), (k +8, m +0), (k +8, m +8) give the
  // A fragments a0..a3 of the warp's 16 features.
  const int a_mat = lane >> 3;
  const int a_row = (a_mat >> 1) * 8 + (lane & 7);
  const int a_ch = 2 * warp + (a_mat & 1);
  // ldmatrix.x2: lanes 0-7 address rows of the k +0 matrix, 8-15 the k +8.
  const int b_ch = (lane >> 3) & 1;

  auto compute_stage = [&](int slot) {
    const uint32_t st = sbase + slot * stage_bytes;
    const uint32_t xs = st + (GATED ? 2 : 1) * MM_TILE;
#pragma unroll
    for (int ks = 0; ks < MM_BK / 16; ++ks) {
      uint32_t fa0[4], fa1[4];
      const uint32_t aoff = swz(ks * 16 + a_row, a_ch);
      ldsm_x4_trans(st + aoff, fa0);
      if constexpr (GATED) ldsm_x4_trans(st + MM_TILE + aoff, fa1);
#pragma unroll
      for (int nb = 0; nb < MM_NB; ++nb) {
        if (nb < nb_live) {
          uint32_t b0, b1;
          ldsm_x2(xs + swz(nb * 8 + (lane & 7), 2 * ks + b_ch), b0, b1);
          mma_bf16(acc0[nb], fa0, b0, b1);
          if constexpr (GATED) mma_bf16(acc1[nb], fa1, b0, b1);
        }
      }
    }
  };

  // Ring: stage kt + STAGES - 1 is copied while stage kt is multiplied. The
  // barrier at the top of step kt also frees the slot read at step kt - 1.
#pragma unroll 1
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();
    const int nxt = kt + MM_STAGES - 1;
    if (nxt < nk) load_stage(nxt % MM_STAGES, nxt);
    cp_async_commit();
    compute_stage(kt % MM_STAGES);
  }
  cp_async_wait<0>();

  // Accumulator j of n-block nb: feature m0 + 16 warp + (lane >> 2) + 8 (j >> 1),
  // bucket row 8 nb + 2 (lane & 3) + (j & 1).
  const int mf = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int nb = 0; nb < MM_NB; ++nb) {
    if (nb < nb_live) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = mf + (j >> 1) * 8;
        const int r = nb * 8 + 2 * (lane & 3) + (j & 1);
        if (r < nrow && m < M) {
          float val;
          if constexpr (GATED) {
            val = act_apply(acc0[nb][j], act) * acc1[nb][j];
          } else {
            val = r < nlive ? acc0[nb][j] : 0.f;
          }
          outb[(size_t)r * M + m] = __float2bfloat16(val);
        }
      }
    }
  }
  if constexpr (!GATED) {  // rows past the last live n-block
    const int rz = nb_live * 8;
    for (int i = threadIdx.x; i < max(0, nrow - rz) * MM_BM; i += MM_THREADS) {
      const int m = m0 + i % MM_BM;
      if (m < M) outb[(size_t)(rz + i / MM_BM) * M + m] = zero;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA
// ---------------------------------------------------------------------------

constexpr int TC = 8;    // bucket rows per block
constexpr int TN = 64;   // output columns per block: 32 lanes x 2
constexpr int NW = 8;    // warps per block, splitting the reduction rows
constexpr int KC = 256;  // reduction rows staged in shared memory at once

// GATED:  out[e][c][n] = act(a[e][c] . w0[e][:, n]) * (a[e][c] . w1[e][:, n])
// !GATED: out[e][c][n] = c < gs[e] ? a[e][c] . w0[e][:, n] : 0
// a: (E, C, K); w0/w1: (E, K, N); out: (E, C, N); N even.
template <bool GATED>
__global__ void __launch_bounds__(32 * NW)
fma_kernel(const float* __restrict__ a, const float* __restrict__ w0,
           const float* __restrict__ w1, const int* __restrict__ gs,
           float* __restrict__ out, int C, int K, int N, int act) {
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * TC;
  const int n0 = blockIdx.x * TN;
  const int live = gs[e];
  const int rows = min(TC, C - c0);

  if (c0 >= live) {  // dead block: read no weights
    if constexpr (!GATED) {
      for (int i = threadIdx.x; i < TC * TN; i += 32 * NW) {
        const int c = i / TN, col = n0 + i % TN;
        if (c < rows && col < N) out[((size_t)e * C + c0 + c) * N + col] = 0.f;
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = n0 + 2 * lane;
  const bool col_ok = n < N;
  const float* arow = a + ((size_t)e * C + c0) * K;
  const float* w0e = w0 + (size_t)e * K * N;
  const float* w1e = GATED ? w1 + (size_t)e * K * N : nullptr;

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
      xs[kk][c] = (c < rows && kk < kn) ? arow[(size_t)c * K + kb + kk] : 0.f;
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
    out[((size_t)e * C + row) * N + col] = val;
  }
}

// Launch geometry, computed by the wrapper (kernels/moe_gmm.py:geometry)
// and checked here against the kernels' compile-time tiles.
struct Geometry {
  int route;       // 0 = fma (fp32), 1 = mma (bf16)
  int grid_up_x;   // feature tiles of the gate/up launch
  int grid_down_x; // feature tiles of the down launch
  int grid_y;      // bucket-row blocks
  int threads;
  int rows_pad;    // bucket rows staged per ring stage (mma)
  int smem_up;     // dynamic shared memory bytes (mma)
  int smem_down;
};

bool geometry_ok(const Geometry& g, int C, int d, int F) {
  auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const int rows = C < MM_ROWS ? C : MM_ROWS;  // bucket rows of a block
  if (g.route == 0)
    return g.grid_up_x == cdiv(F, TN) && g.grid_down_x == cdiv(d, TN) &&
           g.grid_y == cdiv(C, TC) && g.threads == 32 * NW;
  return g.grid_up_x == cdiv(F, MM_BM) && g.grid_down_x == cdiv(d, MM_BM) &&
         g.grid_y == cdiv(C, MM_ROWS) && g.threads == MM_THREADS &&
         g.rows_pad >= 8 * cdiv(rows, 8) && g.rows_pad <= MM_ROWS &&
         g.smem_up == MM_STAGES * mm_stage_bytes(true, g.rows_pad) &&
         g.smem_down == MM_STAGES * mm_stage_bytes(false, g.rows_pad) && d % 8 == 0 &&
         F % 8 == 0;
}

int launch_mma(const Geometry& g, const void* x, const void* wg, const void* wu,
               const void* wd, const int* gs, void* h, void* y, int E, int C, int d,
               int F, int act, cudaStream_t st) {
  static int set_up = 48 * 1024, set_down = 48 * 1024;  // opt-ins so far
  cudaError_t err = cudaSuccess;
  if (g.smem_up > set_up) {
    err = cudaFuncSetAttribute(mma_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g.smem_up);
    if (err != cudaSuccess) return err;
    set_up = g.smem_up;
  }
  if (g.smem_down > set_down) {
    err = cudaFuncSetAttribute(mma_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g.smem_down);
    if (err != cudaSuccess) return err;
    set_down = g.smem_down;
  }
  mma_kernel<true><<<dim3(g.grid_up_x, g.grid_y, E), g.threads, g.smem_up, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), gs, static_cast<bf16*>(h), C, d, F, g.rows_pad, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mma_kernel<false><<<dim3(g.grid_down_x, g.grid_y, E), g.threads, g.smem_down, st>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wd), nullptr, gs,
      static_cast<bf16*>(y), C, F, d, g.rows_pad, 0);
  return cudaGetLastError();
}

int launch_fma(const Geometry& g, const void* x, const void* wg, const void* wu,
               const void* wd, const int* gs, void* h, void* y, int E, int C, int d,
               int F, int act, cudaStream_t st) {
  fma_kernel<true><<<dim3(g.grid_up_x, g.grid_y, E), g.threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg),
      static_cast<const float*>(wu), gs, static_cast<float*>(h), C, d, F, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fma_kernel<false><<<dim3(g.grid_down_x, g.grid_y, E), g.threads, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(wd), nullptr, gs,
      static_cast<float*>(y), C, F, d, 0);
  return cudaGetLastError();
}

}  // namespace

// geo: the 8 ints of Geometry, in order. act: 0 = swiglu, 1 = geglu.
// route 1 takes bfloat16 tensors, route 0 float32. h: (E, C, F) scratch.
// Returns cudaGetLastError() after both launches (0 = launched), or
// cudaErrorInvalidValue if the geometry does not match the kernels' tiles.
extern "C" int moe_gmm_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, const void* group_sizes, void* h,
                              void* y, int E, int C, int d, int F, int act,
                              const int* geo, void* stream) {
  Geometry g;
  g.route = geo[0];
  g.grid_up_x = geo[1];
  g.grid_down_x = geo[2];
  g.grid_y = geo[3];
  g.threads = geo[4];
  g.rows_pad = geo[5];
  g.smem_up = geo[6];
  g.smem_down = geo[7];
  if (!geometry_ok(g, C, d, F)) return cudaErrorInvalidValue;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.route == 1) return launch_mma(g, x, wg, wu, wd, gs, h, y, E, C, d, F, act, st);
  return launch_fma(g, x, wg, wu, wd, gs, h, y, E, C, d, F, act, st);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
