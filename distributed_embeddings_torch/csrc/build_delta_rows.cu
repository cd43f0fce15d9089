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
// merge minor dimensions; its block-size limits are not carried over. Here
// one warp takes one occurrence: lane l owns output lanes 4l..4l+3 and
// writes them with one 16-byte store, so the warp writes the whole 512-byte
// physical row, coalesced. A lane inside the occurrence's window reads its
// cotangent value from the sample's dz row (shared by the h occurrences of
// the sample, through L1) and its state lanes, runs the rule's arithmetic in
// registers and keeps the part (table delta or one state delta) its output
// lane holds. The rule is a template parameter; the learning rate, the
// rule's constants and Adam's bias corrections are host scalars, so the
// kernel reads nothing from the device but its inputs.
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
// bound of each stream it times (k6_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPhys = 128;  // f32 lanes of a physical row (32 x float4)

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

template <int kRule, int kAux>
void launch(unsigned blocks, cudaStream_t stream, const float* dz, int w,
            const int64_t* sub, const float* aux, int aux_last, int stride,
            int rpp, int h, int64_t n, float* out, const Scalars& s) {
  build_delta_rows_kernel<kRule, kAux><<<blocks, kThreads, 0, stream>>>(
      dz, w, sub, aux, aux_last, stride, rpp, h, n, out, s);
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
  const auto b = static_cast<unsigned>(blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(dz);
  const auto* sb = static_cast<const int64_t*>(sub);
  const auto* a = static_cast<const float*>(aux);
  auto* o = static_cast<float*>(out);
  switch (rule) {
    case kAdagrad:
      launch<kAdagrad, 1>(b, st, d, w, sb, a, aux_last, stride, rpp, h, n, o,
                          s);
      break;
    case kMomentum:
      launch<kMomentum, 1>(b, st, d, w, sb, a, aux_last, stride, rpp, h, n, o,
                           s);
      break;
    default:
      launch<kAdam, 2>(b, st, d, w, sb, a, aux_last, stride, rpp, h, n, o, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
