// K6: the fused delta build of the sparse apply, written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_delta.py:
// build_delta_rows. For one bucket of a narrow packed class with optimizer
// state (w table lanes, n_aux state slots of w lanes each, stride =
// w * (1 + n_aux) lanes per logical row, rpp = 128 / stride logical rows
// per 128-lane physical row) and n = K * h occurrences:
//
//     g      = dz[i / h, :]                          (hotness broadcast)
//     aux_a  = lanes [w + a*w, w + (a+1)*w) of occurrence i's fused row:
//              of aux[i] itself when aux_last == stride, else the sum over
//              the rpp windows of the window-masked physical row aux[i]
//     d      = rule(g, aux_0, .., step)               ([stride] lanes)
//     out[i] = d in window sub[i], zero in the other windows and padding
//
// out is [n, 128] f32, the physical-row updates kernel K1 (apply_rows.cu)
// adds into the buffer. Invalid ids are dropped by K1, not here.
//
// The TPU kernel blocks K samples through VMEM and unrolls the h
// occurrences and rpp windows as static lane slices because Mosaic cannot
// merge minor dimensions; its block-size limits are not carried over.
//
// Here the work of an occurrence is its window: G = stride / 4 float4s of
// rule arithmetic; the other 32 - G float4s of its 512-byte output row are
// zeros. The vector path (w a multiple of 4, every row 16-byte aligned) so
// gives each occurrence a group of GP lanes (GP the power of two >= G) and
// each warp 32 / GP occurrences in a row, sample-major: 4 occurrences a
// warp at w16 with Adagrad (stride 32), 8 at w8. Lane j < G of a group
// computes float4 j of its occurrence's window:
//
//   - its part (table delta or state slot) and logical lanes q..q+3 follow
//     from j alone, so its loads do not wait for sub: the cotangent float4
//     of sample i / h (a 32-bit division, once), and for each state slot
//     the rule needs, one 16-byte load of a stride-wide row, or the rpp
//     windows' float4s of a window-masked row, summed in window order (the
//     plain version's order, so the fold changes no bit);
//   - it runs the rule's arithmetic on four values in registers.
//
// Then every lane writes one float4 of each of the warp's rows: the value
// of the group's lane whose window position it holds, fetched by shuffle,
// or zero. Each row leaves as one coalesced 512-byte store of the warp.
// Rows of other widths, or misaligned ones, take the general path: one
// warp an occurrence, one scalar load per value.
//
// Every operation rounds as the plain version's separate PyTorch ops do:
// the _rn intrinsics keep nvcc from contracting a multiply and an add into
// one FMA, square roots and divisions are IEEE (no fast math), and
// Adagrad's rsqrt is 1 / sqrtf, within a few ulps of torch.rsqrt.
//
// Bound: per occurrence the function must read the sub index (8 B) and the
// n_aux * w state lanes it uses (4 * n_aux * w B of a stride-wide row; of
// each of the rpp windows of a masked row, which it sums), per sample the
// dz row (4 * w B), and write the 512-byte output row. The other lanes of
// an aux row are never read. A few dozen flops per lane are far below any
// compute rate, so the kernel is memory-bound; chip_smoke.py computes the
// bound of each stream it times (k6_bytes). The vector path asks for only
// those bytes, 16 at a time; the card fetches 64-byte pairs of sectors, so
// at w8 a masked row's table sectors come along all the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPhys = 128;  // f32 lanes of a physical row (32 x float4)
constexpr unsigned kFull = 0xffffffffu;

enum RuleId { kAdagrad = 0, kMomentum = 1, kAdam = 2 };

struct Scalars {
  float p[6];
};

// One part of the rule's delta at one logical lane: part 0 is the table
// delta, part 1 + a the delta of state slot a.
//
// adagrad  p = (lr, eps):          [-lr * g * rsqrt(acc + g^2 + eps) | g^2]
// momentum p = (lr, mom, nesterov): [-lr * upd | m' - m], m' = mom * m + g
// adam     p = (lr, 1-b1, 1-b2, 1-b1^t, 1-b2^t, eps): [-lr * upd | dm | dv]
template <int kRule>
__device__ __forceinline__ float rule_part(int part, float g, float a0,
                                           float a1, const Scalars& s);

template <>
__device__ __forceinline__ float rule_part<kAdagrad>(int part, float g,
                                                     float a0, float,
                                                     const Scalars& s) {
  const float g2 = __fmul_rn(g, g);
  if (part == 1) {
    return g2;
  }
  const float acc = __fadd_rn(a0, g2);
  const float scaled =
      acc > 0.f ? __fmul_rn(g, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(acc, s.p[1]))))
                : 0.f;
  return __fmul_rn(-s.p[0], scaled);
}

template <>
__device__ __forceinline__ float rule_part<kMomentum>(int part, float g,
                                                      float a0, float,
                                                      const Scalars& s) {
  const float m_new = __fadd_rn(__fmul_rn(s.p[1], a0), g);
  if (part == 1) {
    return __fsub_rn(m_new, a0);
  }
  const float upd =
      s.p[2] != 0.f ? __fadd_rn(g, __fmul_rn(s.p[1], m_new)) : m_new;
  return __fmul_rn(-s.p[0], upd);
}

template <>
__device__ __forceinline__ float rule_part<kAdam>(int part, float g, float a0,
                                                  float a1, const Scalars& s) {
  const float dm = __fmul_rn(s.p[1], __fsub_rn(g, a0));
  if (part == 1) {
    return dm;
  }
  const float dv = __fmul_rn(s.p[2], __fsub_rn(__fmul_rn(g, g), a1));
  if (part == 2) {
    return dv;
  }
  const float m_hat = __fdiv_rn(__fadd_rn(a0, dm), s.p[3]);
  const float v_hat = __fdiv_rn(__fadd_rn(a1, dv), s.p[4]);
  const float upd = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), s.p[5]));
  return __fmul_rn(-s.p[0], upd);
}

// State lane q of slot a for occurrence row `row` (aux_last lanes).
__device__ __forceinline__ float aux_lane(const float* __restrict__ row,
                                          int aux_last, int stride, int rpp,
                                          int w, int a, int q) {
  const int off = w + a * w + q;
  float v = __ldg(row + off);
  if (aux_last != stride) {  // window-masked physical row: fold the windows
    for (int s = 1; s < rpp; ++s) {
      v = __fadd_rn(v, __ldg(row + s * stride + off));
    }
  }
  return v;
}

// Which state slots the rule's part reads (Adagrad's g^2 and Adam's dm
// and dv read fewer than the table delta).
template <int kRule>
__device__ __forceinline__ bool reads_slot(int part, int a) {
  if (kRule == kAdagrad) {
    return part == 0;
  }
  if (kRule == kAdam) {
    return a == 0 ? part != 2 : part != 1;
  }
  return true;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// State lanes off..off+3 of an occurrence's row: one float4 of a
// stride-wide row, or the sum of the rpp windows' float4s of a masked one,
// in window order.
__device__ __forceinline__ float4 state4(const float* __restrict__ row,
                                         bool masked, int stride, int rpp,
                                         int off) {
  float4 v = ldg4(row + off);
  if (masked) {
#pragma unroll 8
    for (int t = 1; t < rpp; ++t) {
      const float4 u = ldg4(row + t * stride + off);
      v = make_float4(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y),
                      __fadd_rn(v.z, u.z), __fadd_rn(v.w, u.w));
    }
  }
  return v;
}

// Blocks an SM keeps resident: the loads in flight grow with the warps, so
// each rule gets the most that fit its registers without spills (Adagrad
// 32 a thread, momentum 40, Adam 48).
template <int kRule>
constexpr int vec_min_blocks() {
  return kRule == kAdagrad ? 8 : kRule == kMomentum ? 6 : 5;
}

template <int kRule, int kAux>
__global__ void __launch_bounds__(kThreads, vec_min_blocks<kRule>())
build_delta_vec_kernel(const float* __restrict__ dz, int w,
                       const int64_t* __restrict__ sub,
                       const float* __restrict__ aux, int aux_last,
                       int stride, int rpp, int h, int64_t n,
                       float* __restrict__ out, Scalars s, int gp_log2) {
  const int lane = threadIdx.x & 31;
  const int opw = 32 >> gp_log2;     // occurrences a warp
  const int g_lanes = stride >> 2;   // float4s of a window
  const int w4 = w >> 2;
  const int grp = lane >> gp_log2;
  const int j = lane & ((1 << gp_log2) - 1);
  const int64_t base =
      ((static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5) *
      opw;
  const int64_t i = base + grp;
  int win = -1;
  float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n && j < g_lanes) {
    const int part = (j >= w4) + (j >= 2 * w4);
    const int q = 4 * (j - part * w4);
    const unsigned k = static_cast<unsigned>(i) / static_cast<unsigned>(h);
    const float4 g = ldg4(dz + static_cast<int64_t>(k) * w + q);
    const float* row = aux + i * aux_last;
    const bool masked = aux_last != stride;
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a1 = a0;
    if (reads_slot<kRule>(part, 0)) {
      a0 = state4(row, masked, stride, rpp, w + q);
    }
    if (kAux > 1 && reads_slot<kRule>(part, 1)) {
      a1 = state4(row, masked, stride, rpp, 2 * w + q);
    }
    win = static_cast<int>(sub[i]);
    val = make_float4(rule_part<kRule>(part, g.x, a0.x, a1.x, s),
                      rule_part<kRule>(part, g.y, a0.y, a1.y, s),
                      rule_part<kRule>(part, g.z, a0.z, a1.z, s),
                      rule_part<kRule>(part, g.w, a0.w, a1.w, s));
  }
  float4* dst = reinterpret_cast<float4*>(out) + base * (kPhys / 4) + lane;
  for (int r = 0; r < opw; ++r) {
    const int src0 = r << gp_log2;  // the group's lane 0
    const int wr = __shfl_sync(kFull, win, src0);
    const int rel = lane - wr * g_lanes;
    const bool in = wr >= 0 && rel >= 0 && rel < g_lanes;
    const int src = in ? src0 + rel : lane;
    float4 v = make_float4(__shfl_sync(kFull, val.x, src),
                           __shfl_sync(kFull, val.y, src),
                           __shfl_sync(kFull, val.z, src),
                           __shfl_sync(kFull, val.w, src));
    if (!in) {
      v = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (base + r < n) {
      dst[r * (kPhys / 4)] = v;
    }
  }
}

// The general path: one warp an occurrence, lane l owns output lanes
// 4l..4l+3 and reads each value it needs with a scalar load.
template <int kRule, int kAux>
__global__ void __launch_bounds__(kThreads)
build_delta_rows_kernel(const float* __restrict__ dz, int w,
                        const int64_t* __restrict__ sub,
                        const float* __restrict__ aux, int aux_last,
                        int stride, int rpp, int h, int64_t n,
                        float* __restrict__ out, Scalars s) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (i >= n) {
    return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t win = sub[i];
  const float* g_row = dz + (i / h) * w;
  const float* a_row = aux + i * aux_last;
  const int lo = static_cast<int>(win) * stride;  // the window's first lane
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int o = 4 * lane + e - lo;  // lane offset inside the window
    v[e] = 0.f;
    if (o >= 0 && o < stride) {
      const int part = o / w;
      const int q = o - part * w;
      const float g = __ldg(g_row + q);
      const float a0 = aux_lane(a_row, aux_last, stride, rpp, w, 0, q);
      const float a1 =
          kAux > 1 ? aux_lane(a_row, aux_last, stride, rpp, w, 1, q) : 0.f;
      v[e] = rule_part<kRule>(part, g, a0, a1, s);
    }
  }
  reinterpret_cast<float4*>(out + i * kPhys)[lane] =
      make_float4(v[0], v[1], v[2], v[3]);
}

// The vector path's lanes per occurrence, log2: the power of two >= stride
// / 4, or -1 where the general path runs (w not a multiple of 4, rows not
// 16-byte aligned, n past 32-bit sample indices).
int vec_gp_log2(const void* dz, int w, const void* aux, int aux_last,
                int stride, int64_t n, const void* out) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (w % 4 != 0 || aux_last % 4 != 0 || n > 0x7fffffffLL ||
      misaligned(dz) || misaligned(aux) || misaligned(out)) {
    return -1;
  }
  int lg = 0;
  while ((1 << lg) < stride / 4) {
    ++lg;
  }
  return lg;
}

template <int kRule, int kAux>
void launch(cudaStream_t stream, const float* dz, int w, const int64_t* sub,
            const float* aux, int aux_last, int stride, int rpp, int h,
            int64_t n, float* out, const Scalars& s, int gp_log2) {
  if (gp_log2 < 0) {
    const auto blocks = static_cast<unsigned>((n * 32 + kThreads - 1) /
                                              kThreads);
    build_delta_rows_kernel<kRule, kAux><<<blocks, kThreads, 0, stream>>>(
        dz, w, sub, aux, aux_last, stride, rpp, h, n, out, s);
    return;
  }
  const int64_t warps = (n + (32 >> gp_log2) - 1) / (32 >> gp_log2);
  const auto blocks = static_cast<unsigned>((warps * 32 + kThreads - 1) /
                                            kThreads);
  build_delta_vec_kernel<kRule, kAux><<<blocks, kThreads, 0, stream>>>(
      dz, w, sub, aux, aux_last, stride, rpp, h, n, out, s, gp_log2);
}

}  // namespace

// rule: 0 adagrad (n_aux 1), 1 momentum (n_aux 1), 2 adam (n_aux 2).
// dz: [n / h, w] f32, contiguous; sub: [n] int64 windows in [0, rpp);
// aux: [n, aux_last] f32, contiguous, aux_last == stride or aux_last >=
// rpp * stride (window-masked physical rows); out: [n, 128] f32,
// contiguous, 16-byte aligned. stride = w * (1 + n_aux) <= 128, rpp =
// 128 / stride. p0..p5: the rule's host scalars. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int build_delta_rows_launch(int rule, int n_aux, const void* dz,
                                       int w, const void* sub, const void* aux,
                                       int aux_last, int stride, int rpp,
                                       int h, int64_t n, void* out, float p0,
                                       float p1, float p2, float p3, float p4,
                                       float p5, void* stream) {
  const int want_aux = rule == kAdam ? 2 : 1;
  if (rule < kAdagrad || rule > kAdam || n_aux != want_aux || w <= 0 ||
      stride != w * (1 + n_aux) || stride > kPhys || rpp != kPhys / stride ||
      h < 1 || n < 0 || n % h != 0 ||
      (aux_last != stride && aux_last < rpp * stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = (n * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scalars s = {{p0, p1, p2, p3, p4, p5}};
  const int gp = vec_gp_log2(dz, w, aux, aux_last, stride, n, out);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(dz);
  const auto* sb = static_cast<const int64_t*>(sub);
  const auto* a = static_cast<const float*>(aux);
  auto* o = static_cast<float*>(out);
  switch (rule) {
    case kAdagrad:
      launch<kAdagrad, 1>(st, d, w, sb, a, aux_last, stride, rpp, h, n, o, s,
                          gp);
      break;
    case kMomentum:
      launch<kMomentum, 1>(st, d, w, sb, a, aux_last, stride, rpp, h, n, o, s,
                           gp);
      break;
    default:
      launch<kAdam, 2>(st, d, w, sb, a, aux_last, stride, rpp, h, n, o, s, gp);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
