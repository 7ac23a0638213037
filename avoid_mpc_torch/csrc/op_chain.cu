// Long chains of one elementwise op, timed on the card with clock64().
//
// Replaces the TPU kernel of avoid_mpc_tpu/tools/vpu_microbench.py
// (_time_chain / _make_kernel), which timed chains on one (8, 128) vector
// register to get VPU cycles per op.  Here the (8, 128) tile is 1024
// elements, one per thread, in 32 one-warp blocks; each warp runs `LANES`
// independent chains of `n_iter` iterations, each iteration applying the op
// `UNROLL` times to every chain, and reads the SM clock around its loop.
// A block of one warp is the unit the solver kernels run today (one warp
// per SM), so:
//   serial (1 chain)          cycles per op = the op's dependent latency;
//   ilp8 (8 chains)           throughput with the loop's own bookkeeping;
//   ilp8x4 (8 chains, 4x)     issue-limited throughput of one warp.
// The ops are the accurate expf / log1pf / sqrtf / tanhf and IEEE division
// that the solver kernels compile to (no --use_fast_math).  An empty
// `asm volatile` after each application keeps the compiler from folding a
// chain (max(max(y, c), c) = max(y, c)); it emits no instruction.
//
// Layout: x (LANES, T) f32 with T a multiple of 32 in, out (T,) = the sum of
// the chains, cycles (T / 32,) int64 = each warp's clock64() delta.
// Bound: operations (the chains read and write 4 (LANES + 1) T bytes).

#include <cuda_runtime.h>
#include <math.h>

#define WARP 32

enum OpId { OP_FMA, OP_MUL, OP_ADD, OP_MAX, OP_EXP, OP_LOG1P, OP_SQRT, OP_RSQRT, OP_DIV,
            OP_TANH, OP_SELECT, N_OPS };

// Each map is bounded, so a chain of any length neither overflows nor
// denormalizes (vpu_microbench.py::OPS).
template <int OP>
__device__ __forceinline__ float apply(float y) {
  if constexpr (OP == OP_FMA) return y * 0.999f + 0.0005f;
  if constexpr (OP == OP_MUL) return y * 1.0000001f;
  if constexpr (OP == OP_ADD) return y + 1e-7f;
  if constexpr (OP == OP_MAX) return fmaxf(y, 0.4999f);
  if constexpr (OP == OP_EXP) return expf(-y);
  if constexpr (OP == OP_LOG1P) return log1pf(y);
  if constexpr (OP == OP_SQRT) return sqrtf(y);
  if constexpr (OP == OP_RSQRT) return rsqrtf(y);
  if constexpr (OP == OP_DIV) return 0.36f / y;
  if constexpr (OP == OP_TANH) return tanhf(y) + 0.5f;
  if constexpr (OP == OP_SELECT) return y > 0.5f ? y * 0.999f : y * 1.001f;
  return y;
}

template <int OP, int LANES, int UNROLL>
__global__ void __launch_bounds__(WARP)
op_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long* __restrict__ cycles, int n_iter, int tile) {
  const int t = blockIdx.x * WARP + threadIdx.x;
  float y[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) y[l] = x[(size_t)l * tile + t];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n_iter; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        y[l] = apply<OP>(y[l]);
        asm volatile("" : "+f"(y[l]));
      }
    }
  }
  const long long t1 = clock64();
  float acc = y[0];
#pragma unroll
  for (int l = 1; l < LANES; ++l) acc = acc + y[l];
  out[t] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int LANES, int UNROLL>
static void launch_mode(int op, const float* x, float* out, long long* cycles, int n_iter,
                        int tile, cudaStream_t s) {
  const dim3 grid(tile / WARP);
  switch (op) {
#define CASE(ID)                                                                            \
  case ID:                                                                                  \
    op_chain_kernel<ID, LANES, UNROLL><<<grid, WARP, 0, s>>>(x, out, cycles, n_iter, tile); \
    break;
    CASE(OP_FMA)
    CASE(OP_MUL)
    CASE(OP_ADD)
    CASE(OP_MAX)
    CASE(OP_EXP)
    CASE(OP_LOG1P)
    CASE(OP_SQRT)
    CASE(OP_RSQRT)
    CASE(OP_DIV)
    CASE(OP_TANH)
    CASE(OP_SELECT)
#undef CASE
  }
}

// ---- host launch (plain C interface, loaded with ctypes) ----

// mode: 0 = serial (1 chain), 1 = ilp8 (8 chains), 2 = ilp8x4 (8 chains, 4x unrolled).
extern "C" int op_chain_launch(int op, int mode, const void* x, void* out, void* cycles,
                               int n_iter, int tile, int device, void* stream) {
  if (op < 0 || op >= N_OPS || mode < 0 || mode > 2 || tile <= 0 || tile % WARP != 0 ||
      n_iter < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  long long* cy = (long long*)cycles;
  if (mode == 0) launch_mode<1, 1>(op, xf, of, cy, n_iter, tile, s);
  if (mode == 1) launch_mode<8, 1>(op, xf, of, cy, n_iter, tile, s);
  if (mode == 2) launch_mode<8, 4>(op, xf, of, cy, n_iter, tile, s);
  return (int)cudaGetLastError();
}
