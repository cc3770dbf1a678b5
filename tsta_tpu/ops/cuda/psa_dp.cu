// Affine-gap global alignment (Gotoh) DP for NVIDIA Hopper, called from
// JAX through the XLA FFI (tsta_tpu/ops/psa_cuda.py builds and binds it).
//
// One thread block aligns one pair: b (rows, length m) against a
// (columns, length n).  The rows are cut into stripes of blockDim.x * R
// rows.  Inside a stripe, thread t owns R consecutive rows and sweeps the
// columns in groups of C, one group per step, one step behind thread t-1
// (an inter-thread anti-diagonal wavefront).  At step k thread t works on
// column group g = k - t and needs the H and E values of the row just
// above its strip for that group: thread t-1 computed them at step k-1
// and hands them over by warp shuffle, or through shared memory across a
// warp boundary.  The last thread of a stripe writes its bottom row to a
// per-pair scratch row, which the first thread of the next stripe reads.
// The H/E/F frontier never leaves registers.
//
// Recurrence and boundary (identical to ops/psa_scan.py, whose closed-form
// F equals the textbook F below whenever gap_open <= 0):
//   E(i,j) = max(E(i-1,j) + e, H(i-1,j) + o + e)
//   F(i,j) = max(F(i,j-1) + e, H(i,j-1) + o + e)
//   H(i,j) = max(H(i-1,j-1) + sub(a_j, b_i), E(i,j), F(i,j))
//   H(-1,-1) = 0, H(-1,j) = o + (j+1)e, H(i,-1) = o + (i+1)e, E(-1,j) = F(i,-1) = -inf
// Hopper's DPX instructions are this update: __viaddmax_s32 gives
// max(x + e, y) and __vimax3_s32 the three-way max.
//
// Outputs per pair: the max over all real H cells, the corner
// H(m_real-1, n_real-1), and (traced) one int8 per cell packed as
// back*9 + f*3 + e, the layout ops/traceback.py walks:
//   back 1 diagonal, 0 left (H == F), 2 up;
//   f/e  0 extend, 1 open, 2 open with an open/extend tie on the next cell.
// The NumPy model in tests/psa_kernel_model.py follows this schedule
// step for step and is checked against psa_scan on the CPU.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int R = 8;           // rows per thread
constexpr int C = 4;           // columns per step (one 32-bit word of a)
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int32_t NEG = -(1 << 28);
constexpr uint8_t B_PAD = 1;   // ops/psa_scan.B_PAD: never equals an a byte

__device__ __forceinline__ int32_t add_max(int32_t x, int32_t e, int32_t y) {
  return __viaddmax_s32(x, e, y);  // max(x + e, y)
}

__device__ __forceinline__ int32_t max3(int32_t x, int32_t y, int32_t z) {
  return __vimax3_s32(x, y, z);
}

__device__ __forceinline__ uint32_t gap_code(bool open, bool tie) {
  return open ? (tie ? 2u : 1u) : 0u;
}

template <bool TRACED>
__global__ void __launch_bounds__(MAX_THREADS)
psa_dp_kernel(const uint8_t* __restrict__ a_all,
              const uint8_t* __restrict__ b_all,
              const int32_t* __restrict__ lens, int n_pad, int m_pad,
              int32_t M, int32_t X, int32_t E, int32_t O,
              int32_t* __restrict__ score_out,
              int32_t* __restrict__ corner_out,
              int32_t* __restrict__ rowbuf_all,
              int8_t* __restrict__ plane_all) {
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_real = lens[2 * p];
  const int m_real = lens[2 * p + 1];
  const uint8_t* a = a_all + (size_t)p * n_pad;
  const uint8_t* b = b_all + (size_t)p * m_pad;
  // two bottom-row buffers (stripe parity), each H[n_pad] then E[n_pad]
  int32_t* rowbuf = rowbuf_all + (size_t)p * 4 * n_pad;
  int8_t* plane = TRACED ? plane_all + (size_t)p * m_pad * n_pad : nullptr;
  const int32_t OE = O + E;
  // traced planes are written 16 columns (four groups) at a time
  const int G = TRACED ? (n_real + 15) / 16 * 4 : (n_real + C - 1) / C;
  const int stripe_rows = T * R;
  const int S = (m_real + stripe_rows - 1) / stripe_rows;

  __shared__ int32_t xH[2][MAX_WARPS][C];
  __shared__ int32_t xE[2][MAX_WARPS][C];
  __shared__ int32_t s_best;
  if (t == 0) s_best = NEG;
  __syncthreads();

  int32_t best = NEG;

  for (int s = 0; s < S; ++s) {
    const int row0 = s * stripe_rows + t * R;
    uint32_t brow[R];
    int32_t hleft[R], fleft[R];
    bool row_ok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      brow[r] = i < m_pad ? b[i] : B_PAD;
      row_ok[r] = i < m_real;
      hleft[r] = O + (i + 1) * E;  // H(i, -1)
      fleft[r] = NEG;
    }
    int32_t hdiag_top = row0 == 0 ? 0 : O + row0 * E;  // H(row0-1, -1)
    int32_t outH[C], outE[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      outH[c] = NEG;
      outE[c] = NEG;
    }
    uint32_t w0[R], w1[R], w2[R];  // traced: the previous three groups' codes
#pragma unroll
    for (int r = 0; r < R; ++r) w0[r] = w1[r] = w2[r] = 0;
    const int32_t* in_h = rowbuf + ((s + 1) & 1) * 2 * n_pad;
    const int32_t* in_e = in_h + n_pad;
    int32_t* out_h = rowbuf + (s & 1) * 2 * n_pad;
    int32_t* out_e = out_h + n_pad;
    int4 pre_h = make_int4(NEG, NEG, NEG, NEG);
    int4 pre_e = pre_h;
    if (t == 0 && s > 0) {
      pre_h = *reinterpret_cast<const int4*>(in_h);
      pre_e = *reinterpret_cast<const int4*>(in_e);
    }

    const int steps = G + T - 1;
    for (int k = 0; k < steps; ++k) {
      const int g = k - t;
      const int j0 = g * C;
      int32_t upH[C], upE[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        upH[c] = __shfl_up_sync(0xffffffffu, outH[c], 1);
        upE[c] = __shfl_up_sync(0xffffffffu, outE[c], 1);
      }
      if (lane == 0) {
        if (warp > 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            upH[c] = xH[(k + 1) & 1][warp - 1][c];
            upE[c] = xE[(k + 1) & 1][warp - 1][c];
          }
        } else if (s == 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            upH[c] = O + (j0 + c + 1) * E;  // H(-1, j)
            upE[c] = NEG;
          }
        } else {
          upH[0] = pre_h.x; upH[1] = pre_h.y; upH[2] = pre_h.z; upH[3] = pre_h.w;
          upE[0] = pre_e.x; upE[1] = pre_e.y; upE[2] = pre_e.z; upE[3] = pre_e.w;
          if (g + 1 < G) {  // prefetch the next group's boundary
            pre_h = *reinterpret_cast<const int4*>(in_h + j0 + C);
            pre_e = *reinterpret_cast<const int4*>(in_e + j0 + C);
          }
        }
      }

      if (g >= 0 && g < G) {
        const uint32_t aw = *reinterpret_cast<const uint32_t*>(a + j0);
        uint32_t code[R];
#pragma unroll
        for (int r = 0; r < R; ++r) code[r] = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const uint32_t aj = (aw >> (8 * c)) & 0xffu;
          const bool col_ok = j0 + c < n_real;
          int32_t hd = c == 0 ? hdiag_top : upH[c - 1];  // H(i-1, j-1)
          int32_t hu = upH[c];                            // H(i-1, j)
          int32_t eu = upE[c];                            // E(i-1, j)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int32_t diag = hd + (aj == brow[r] ? M : X);
            const int32_t e = add_max(eu, E, hu + OE);
            const int32_t f = add_max(fleft[r], E, hleft[r] + OE);
            const int32_t h = max3(diag, e, f);
            if (TRACED) {
              const uint32_t back = h == diag ? 1u : (h == f ? 0u : 2u);
              const uint32_t fc = gap_code(f == hleft[r] + OE, f + E == h + OE);
              const uint32_t ec = gap_code(e == hu + OE, e + E == h + OE);
              code[r] |= (back * 9u + fc * 3u + ec) << (8 * c);
            }
            if (row_ok[r] && col_ok) {
              best = max(best, h);
              if (row0 + r == m_real - 1 && j0 + c == n_real - 1)
                corner_out[p] = h;
            }
            hd = hleft[r];
            hleft[r] = h;
            fleft[r] = f;
            hu = h;
            eu = e;
          }
          outH[c] = hu;
          outE[c] = eu;
        }
        hdiag_top = upH[C - 1];
        if (TRACED) {
          if ((g & 3) == 3) {
            const int col = (g - 3) * C;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (row_ok[r]) {
                *reinterpret_cast<uint4*>(plane + (size_t)(row0 + r) * n_pad + col) =
                    make_uint4(w0[r], w1[r], w2[r], code[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            w0[r] = w1[r];
            w1[r] = w2[r];
            w2[r] = code[r];
          }
        }
        if (t == T - 1 && s + 1 < S) {
          *reinterpret_cast<int4*>(out_h + j0) = make_int4(outH[0], outH[1], outH[2], outH[3]);
          *reinterpret_cast<int4*>(out_e + j0) = make_int4(outE[0], outE[1], outE[2], outE[3]);
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          xH[k & 1][warp][c] = outH[c];
          xE[k & 1][warp][c] = outE[c];
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) atomicMax(&s_best, best);
  __syncthreads();
  if (t == 0) score_out[p] = s_best;
}

template <bool TRACED>
ffi::Error launch(cudaStream_t stream, ffi::Buffer<ffi::U8> a,
                  ffi::Buffer<ffi::U8> b, ffi::Buffer<ffi::S32> lens,
                  int32_t match, int32_t mismatch, int32_t gap_extend,
                  int32_t gap_open, int32_t threads, ffi::Result<ffi::Buffer<ffi::S32>> score,
                  ffi::Result<ffi::Buffer<ffi::S32>> corner,
                  ffi::Result<ffi::Buffer<ffi::S32>> rowbuf, int8_t* plane) {
  const auto ad = a.dimensions();
  const auto bd = b.dimensions();
  if (ad.size() != 2 || bd.size() != 2 || ad[0] != bd[0])
    return ffi::Error::InvalidArgument("a and b must be (P, n) and (P, m)");
  const int64_t P = ad[0], n_pad = ad[1], m_pad = bd[1];
  if (n_pad % 16 != 0)
    return ffi::Error::InvalidArgument("n_pad must be a multiple of 16");
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return ffi::Error::InvalidArgument("threads must be 32..256, a multiple of 32");
  if (P == 0) return ffi::Error::Success();
  psa_dp_kernel<TRACED><<<(unsigned)P, threads, 0, stream>>>(
      a.typed_data(), b.typed_data(), lens.typed_data(), (int)n_pad,
      (int)m_pad, match, mismatch, gap_extend, gap_open,
      score->typed_data(), corner->typed_data(), rowbuf->typed_data(), plane);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("psa_dp launch: ") + cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error score_impl(cudaStream_t stream, ffi::Buffer<ffi::U8> a,
                      ffi::Buffer<ffi::U8> b, ffi::Buffer<ffi::S32> lens,
                      int32_t match, int32_t mismatch, int32_t gap_extend,
                      int32_t gap_open, int32_t threads,
                      ffi::Result<ffi::Buffer<ffi::S32>> score,
                      ffi::Result<ffi::Buffer<ffi::S32>> corner,
                      ffi::Result<ffi::Buffer<ffi::S32>> rowbuf) {
  return launch<false>(stream, a, b, lens, match, mismatch, gap_extend,
                       gap_open, threads, score, corner, rowbuf, nullptr);
}

ffi::Error traced_impl(cudaStream_t stream, ffi::Buffer<ffi::U8> a,
                       ffi::Buffer<ffi::U8> b, ffi::Buffer<ffi::S32> lens,
                       int32_t match, int32_t mismatch, int32_t gap_extend,
                       int32_t gap_open, int32_t threads,
                       ffi::Result<ffi::Buffer<ffi::S32>> score,
                       ffi::Result<ffi::Buffer<ffi::S32>> corner,
                       ffi::Result<ffi::Buffer<ffi::S32>> rowbuf,
                       ffi::Result<ffi::Buffer<ffi::S8>> plane) {
  return launch<true>(stream, a, b, lens, match, mismatch, gap_extend,
                      gap_open, threads, score, corner, rowbuf,
                      plane->typed_data());
}

}  // namespace

#define TSTA_PSA_BINDING                                  \
  ffi::Ffi::Bind()                                        \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()           \
      .Arg<ffi::Buffer<ffi::U8>>()                        \
      .Arg<ffi::Buffer<ffi::U8>>()                        \
      .Arg<ffi::Buffer<ffi::S32>>()                       \
      .Attr<int32_t>("match")                             \
      .Attr<int32_t>("mismatch")                          \
      .Attr<int32_t>("gap_extend")                        \
      .Attr<int32_t>("gap_open")                          \
      .Attr<int32_t>("threads")                           \
      .Ret<ffi::Buffer<ffi::S32>>()                       \
      .Ret<ffi::Buffer<ffi::S32>>()                       \
      .Ret<ffi::Buffer<ffi::S32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(TstaPsaScore, score_impl, TSTA_PSA_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(TstaPsaTraced, traced_impl,
                              TSTA_PSA_BINDING.Ret<ffi::Buffer<ffi::S8>>());
