// The DLRM pairwise interaction's maths, written once for K2 and K3.
//
// K2 (interact_fwd.cu, interact_bwd.cu) reads the F features of a sample
// from F separate [B, D] bf16 parts; K3 (interact_flat_fwd.cu,
// interact_flat_bwd.cu) reads them from one flat [B, F, D] bf16 tensor.
// Both compute the same two functions, so the kernels below are templates
// over a row-address functor: `rows.row(p, s)` is the address of feature
// p of sample s, and the backward's `outs.row(p, s)` the address its
// cotangent row is written to. Everything else (the shared-memory
// staging, the pair table, the f32 sums and the bf16 roundings) is one
// body per direction.
//
// Forward, for each sample b and each pair n = (p, q) in
// np.tril_indices(F, k) order (k = -1, or 0 with self-interaction):
//
//     acts[b, n] = float(bf16_rn(sum_d x_p[b, d] * x_q[b, d]))
//
// with the sum accumulated in f32: the TPU kernels' function (they round
// the F x F pair products to bf16 and select the lower triangle with a
// half-weight matrix M, and 0.5*a + 0.5*a == a).
//
// Backward, given the [B, P] f32 cotangent of the pair activations:
//
//     da = bf16_rn(d_acts[b, :])
//     d_x_p[b, :] = bf16_rn( sum_q c_pq * x_q[b, :] )   (f32 sums)
//
// with c_pq = da[pair(p, q)] for p != q and, on the diagonal,
// c_pp = 2 * da[pair(p, p)] when k = 0 and 0 when k = -1: the TPU kernels'
// 2 * bf16(d_acts . M^T) @ F exactly (M's halves are exact in bf16 and 2 is
// a power of two). Products of bf16 values are exact in f32, so only the
// order of the f32 sums over q can differ from another implementation (the
// backward's tensor-core sums, below, are not rounded at every add either).
//
// Bound on this card, per sample: the forward reads F*D*2 bytes and writes
// P*4; the backward reads P*4 + F*D*2 and writes F*D*2. Their FLOPs are far
// below the bf16 tensor-core rate, so both are memory-bound. Each feature
// row is read from device memory once (16-byte loads into shared memory),
// every pair product stays on chip, and each output is written once. Both
// products run on the tensor cores with their loads overlapped (the
// designs are described above bwd_kernel and fwd_kernel).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace interact {

constexpr int kMaxParts = 32;
constexpr int kThreads = 256;

// K2's inputs: f separate contiguous [b, d] parts
struct PartRows {
  const __nv_bfloat16* p[kMaxParts];
  int d;
  __device__ const __nv_bfloat16* row(int part, size_t sample) const {
    return p[part] + sample * d;
  }
};

// K2-bwd's outputs: f separate contiguous [b, d] parts
struct PartOuts {
  __nv_bfloat16* p[kMaxParts];
  int d;
  __device__ __nv_bfloat16* row(int part, size_t sample) const {
    return p[part] + sample * d;
  }
};

// K3's input: one contiguous [b, f, d] tensor
struct FlatRows {
  const __nv_bfloat16* base;
  int f;
  int d;
  __device__ const __nv_bfloat16* row(int part, size_t sample) const {
    return base + (sample * f + part) * d;
  }
};

// K3-bwd's output: one contiguous [b, f, d] tensor
struct FlatOuts {
  __nv_bfloat16* base;
  int f;
  int d;
  __device__ __nv_bfloat16* row(int part, size_t sample) const {
    return base + (sample * f + part) * d;
  }
};

inline int npair_of(int f, int k) {
  return (k == 0) ? f * (f + 1) / 2 : f * (f - 1) / 2;
}

// the pair table in tril order: row p holds pairs (p, 0) .. (p, p + k)
__device__ inline void fill_pair_table(unsigned char* pair_pq, int f, int k) {
  for (int p = threadIdx.x; p < f; p += blockDim.x) {
    const int start = (k == 0) ? p * (p + 1) / 2 : p * (p - 1) / 2;
    for (int q = 0; q <= p + k; ++q) {
      pair_pq[2 * (start + q)] = static_cast<unsigned char>(p);
      pair_pq[2 * (start + q) + 1] = static_cast<unsigned char>(q);
    }
  }
}

// ---------------------------------------------------------------------------
// The backward on the tensor cores
// ---------------------------------------------------------------------------
//
// Per sample, d_x = C @ X: C the F x F coefficients, X the F x D rows. The
// product is mma.sync.m16n8k16 (bf16 in, f32 sums): C is built in shared
// memory as bf16, zero-padded to 16 or 32 square (exact: every c_pq is a
// bf16 value or twice one), X is staged with its rows padded to the same
// 16 or 32 by zero rows (never stale memory: 0 * NaN is NaN). A fragments
// come from C by ldmatrix, B fragments from X by ldmatrix.trans.
//
// Geometry (ops/cuda_interact.py: bwd_geometry): a unit is `ns` samples x
// one tile of `dt` columns (D > dt loops over column tiles). A persistent
// grid of (blocks per SM) x SMs walks the units; each block double-buffers
// its stage: while it computes one unit, the next unit's rows and its
// [ns, P] cotangent block are in flight as cp.async copies (16 bytes, and
// 4 at the cotangent block's unaligned ends). A warp owns (sample, up to
// four 8-column tiles) over every row of C, so it is the only reader of
// those X columns and writes its bf16 results over them in place; then
// the block writes each output row with coalesced 16-byte stores.

struct BwdGeo {
  int xr;    // staged rows per sample: the MMA's K, 16 or 32
  int mt;    // 16-row M tiles: 1 or 2
  int re;    // bf16 elements per staged row: dt + pad
  int cc;    // bf16 elements per C row: xr + 8
  int dt;    // columns per tile
  int ndt;   // column tiles
  int ns;    // samples per unit
  size_t x_stage, a_stage, c_bytes, pair_bytes, smem;
};

constexpr int kBwdNChunk = 4;  // 8-column tiles per warp item
constexpr size_t kSmemMax = 227 * 1024;

inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

inline BwdGeo bwd_geo(int f, int d, int npair, int ns, int dt) {
  BwdGeo g;
  g.xr = f <= 16 ? 16 : 32;
  g.mt = g.xr / 16;
  // a row stride of an odd number of 16-byte units: the eight rows of an
  // ldmatrix hit eight different bank quads
  g.re = dt + (((dt / 8) % 2 == 0) ? 8 : 16);
  g.cc = g.xr + 8;
  g.dt = dt;
  g.ndt = (d + dt - 1) / dt;
  g.ns = ns;
  g.x_stage = static_cast<size_t>(ns) * g.xr * g.re * sizeof(__nv_bfloat16);
  // the cotangent block lands at its source's offset mod 16 bytes
  g.a_stage = round16((static_cast<size_t>(ns) * npair + 4) * sizeof(float));
  g.c_bytes =
      static_cast<size_t>(ns) * g.mt * 16 * g.cc * sizeof(__nv_bfloat16);
  g.pair_bytes = round16(2 * static_cast<size_t>(npair));
  g.smem = 2 * (g.x_stage + g.a_stage) + g.c_bytes + g.pair_bytes;
  return g;
}

inline bool bwd_args_ok(int f, int b, int d, int k, int ns, int dt) {
  return f >= 1 && f <= kMaxParts && b >= 0 && d > 0 && d % 8 == 0 &&
         (k == 0 || k == -1) && ns >= 1 && dt >= 8 && dt % 8 == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most `n` of this thread's latest copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one unit's position: samples [s0, s0 + nsa), columns [d0, d0 + dn)
struct BwdUnit {
  int s0, nsa, d0, dn;
};

__device__ __forceinline__ BwdUnit unit_of(int u, const BwdGeo& g, int b,
                                           int d) {
  const int grp = u / g.ndt;
  BwdUnit t;
  t.s0 = grp * g.ns;
  t.nsa = min(g.ns, b - t.s0);
  t.d0 = (u - grp * g.ndt) * g.dt;
  t.dn = min(g.dt, d - t.d0);
  return t;
}

// where a unit's cotangent block starts in its stage (its source's phase)
__device__ __forceinline__ int phase_of(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// The rows of a unit as a thread walks them: index i = (s * f + p) * vpr
// + c (sample, feature, 16-byte vector), stepped by the block's size. The
// start and the step's digits are divided out once per kernel, so a step
// costs a few adds where a division costs some twenty instructions.
struct RowWalk {
  int c, p, s;     // the thread's current position
  int dc, dp, ds;  // the step, in the same digits
  int vpr, f;
  __device__ RowWalk(int i, int step, int vpr_, int f_) : vpr(vpr_), f(f_) {
    c = i % vpr;
    const int r = i / vpr;
    p = r % f;
    s = r / f;
    dc = step % vpr;
    const int dr = step / vpr;
    dp = dr % f;
    ds = dr / f;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    int carry = 0;
    if (c >= vpr) {
      c -= vpr;
      carry = 1;
    }
    p += dp + carry;
    s += ds;
    if (p >= f) {
      p -= f;
      s += 1;
    }
  }
};

// the same for (sample, pair) of the cotangent block: i = s * npair + n
struct PairWalk {
  int n, s, dn, ds, npair;
  __device__ PairWalk(int i, int step, int npair_) : npair(npair_) {
    n = i % npair;
    s = i / npair;
    dn = step % npair;
    ds = step / npair;
  }
  __device__ __forceinline__ void next() {
    n += dn;
    s += ds;
    if (n >= npair) {
      n -= npair;
      s += 1;
    }
  }
};

// start the copies of unit `t`'s rows and cotangent block into a stage
template <typename Rows>
__device__ __forceinline__ void issue_unit(const Rows& in,
                                           const float* d_acts,
                                           const BwdUnit& t, const BwdGeo& g,
                                           int f, int npair, RowWalk w,
                                           __nv_bfloat16* xs, float* as) {
  const int total = t.nsa * f * (t.dn / 8);
  for (int i = threadIdx.x; i < total; i += blockDim.x, w.next()) {
    cp_async16(xs + (w.s * g.xr + w.p) * g.re + w.c * 8,
               in.row(w.p, static_cast<size_t>(t.s0 + w.s)) + t.d0 + w.c * 8);
  }
  const float* src = d_acts + static_cast<size_t>(t.s0) * npair;
  float* dst = as + phase_of(src);
  const int n = t.nsa * npair;
  const int head = min(n, (4 - phase_of(src)) & 3);
  const int nvec = (n - head) / 4;
  const int tail = head + 4 * nvec;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    cp_async4(dst + i, src + i);
  }
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  }
  for (int i = tail + threadIdx.x; i < n; i += blockDim.x) {
    cp_async4(dst + i, src + i);
  }
}

template <typename Rows, typename Outs>
__global__ void __launch_bounds__(kThreads, 2)
bwd_kernel(Rows in, Outs outs, const float* __restrict__ d_acts, int f, int b,
           int d, int k, int npair, BwdGeo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_units = ((b + g.ns - 1) / g.ns) * g.ndt;

  if (npair == 0) {
    // F = 1 without self-interaction: no pair, a zero cotangent
    const int vpr = d / 8;
    const size_t total = static_cast<size_t>(f) * b * vpr;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
         i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
      const int c = static_cast<int>(i % vpr);
      const size_t r = i / vpr;
      *reinterpret_cast<uint4*>(outs.row(static_cast<int>(r % f), r / f) +
                                c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // stage i's rows at smem_raw + i * x_stage, its cotangent block at
  // a_base + i * a_stage (computed, not indexed: no local-memory array)
  unsigned char* const a_base = smem_raw + 2 * g.x_stage;
  auto xs = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + i * g.x_stage);
  };
  auto as = [&](int i) {
    return reinterpret_cast<float*>(a_base + i * g.a_stage);
  };
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + 2 * (g.x_stage + g.a_stage));
  unsigned char* pair_pq = smem_raw + 2 * (g.x_stage + g.a_stage) + g.c_bytes;

  fill_pair_table(pair_pq, f, k);
  // the pad rows of X and the pad cells (and a k = -1 diagonal) of C are
  // zero for the whole run: loads write rows < f, builds pair cells only
  {
    const uint4 z = make_uint4(0, 0, 0, 0);
    uint4* xz = reinterpret_cast<uint4*>(smem_raw);
    for (size_t i = threadIdx.x; i < 2 * g.x_stage / 16; i += blockDim.x) {
      xz[i] = z;
    }
    uint4* cz = reinterpret_cast<uint4*>(cs);
    for (size_t i = threadIdx.x; i < g.c_bytes / 16; i += blockDim.x) {
      cz[i] = z;
    }
  }
  __syncthreads();

  // the walks' starts: full-width tiles, and a narrower last one
  const RowWalk walk_full(threadIdx.x, kThreads, g.dt / 8, f);
  const int last_dn = d - (g.ndt - 1) * g.dt;
  const RowWalk walk_last(threadIdx.x, kThreads, last_dn / 8, f);
  const PairWalk walk_pairs(threadIdx.x, kThreads, npair);

  int u = blockIdx.x;
  if (u < n_units) {
    const BwdUnit t0 = unit_of(u, g, b, d);
    issue_unit(in, d_acts, t0, g, f, npair,
               t0.dn == g.dt ? walk_full : walk_last, xs(0), as(0));
  }
  cp_async_commit();
  const int ksteps = g.xr / 16;
  const int rows_c = g.mt * 16;
  for (int it = 0; u < n_units; u += gridDim.x, ++it) {
    const int cur = it & 1;
    const BwdUnit t = unit_of(u, g, b, d);
    cp_async_wait_all();
    __syncthreads();  // this unit's stage is in; the other one is free
    if (u + static_cast<int>(gridDim.x) < n_units) {
      const BwdUnit tn = unit_of(u + gridDim.x, g, b, d);
      issue_unit(in, d_acts, tn, g, f, npair,
                 tn.dn == g.dt ? walk_full : walk_last, xs(cur ^ 1),
                 as(cur ^ 1));
    }
    cp_async_commit();

    // the pair cells of C from the bf16-rounded cotangent
    const float* da =
        as(cur) + phase_of(d_acts + static_cast<size_t>(t.s0) * npair);
    PairWalk pw = walk_pairs;
    for (int i = threadIdx.x; i < t.nsa * npair; i += blockDim.x, pw.next()) {
      const int p = pair_pq[2 * pw.n];
      const int q = pair_pq[2 * pw.n + 1];
      const __nv_bfloat16 c = __float2bfloat16_rn(da[i]);
      __nv_bfloat16* cm = cs + pw.s * rows_c * g.cc;
      if (p == q) {
        cm[p * g.cc + p] = __float2bfloat16_rn(2.f * __bfloat162float(c));
      } else {
        cm[p * g.cc + q] = c;
        cm[q * g.cc + p] = c;
      }
    }
    __syncthreads();

    // items: (sample, chunk of up to four 8-column tiles), one per warp
    const int ntiles = t.dn / 8;
    const int nchunk = (ntiles + kBwdNChunk - 1) / kBwdNChunk;
    for (int item = warp; item < t.nsa * nchunk; item += kThreads / 32) {
      const int s = item / nchunk;
      const int nt0 = (item - s * nchunk) * kBwdNChunk;
      const int cnt = min(kBwdNChunk, ntiles - nt0);
      __nv_bfloat16* xm = xs(cur) + s * g.xr * g.re;
      const __nv_bfloat16* cm = cs + s * rows_c * g.cc;
      unsigned a[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          if (m < g.mt && ks < ksteps) {
            ldmatrix_x4(a[m][ks], cm + (m * 16 + (lane & 15)) * g.cc +
                                      ks * 16 + (lane >> 4) * 8);
          }
        }
      }
      float acc[2][kBwdNChunk][4] = {};
#pragma unroll
      for (int j = 0; j < kBwdNChunk; ++j) {
        if (j < cnt) {
          const int n0 = (nt0 + j) * 8;
          unsigned bf[4];
          if (ksteps == 2) {
            ldmatrix_x4_trans(bf, xm + lane * g.re + n0);
          } else {
            ldmatrix_x2_trans(bf, xm + (lane & 15) * g.re + n0);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              if (m < g.mt && ks < ksteps) {
                mma_bf16(acc[m][j], a[m][ks], bf[2 * ks], bf[2 * ks + 1]);
              }
            }
          }
        }
      }
      __syncwarp();
      // in place over the columns this warp alone has read
      const int gr = lane >> 2;
      const int col = 2 * (lane & 3);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < kBwdNChunk; ++j) {
          if (m < g.mt && j < cnt) {
            const int p0 = m * 16 + gr;
            __nv_bfloat16* o = xm + (nt0 + j) * 8 + col;
            if (p0 < f) {
              *reinterpret_cast<__nv_bfloat162*>(o + p0 * g.re) =
                  __floats2bfloat162_rn(acc[m][j][0], acc[m][j][1]);
            }
            if (p0 + 8 < f) {
              *reinterpret_cast<__nv_bfloat162*>(o + (p0 + 8) * g.re) =
                  __floats2bfloat162_rn(acc[m][j][2], acc[m][j][3]);
            }
          }
        }
      }
    }
    __syncthreads();

    // rows < f out, 16 bytes per thread, consecutive threads along a row
    RowWalk w = t.dn == g.dt ? walk_full : walk_last;
    for (int i = threadIdx.x; i < t.nsa * f * (t.dn / 8);
         i += blockDim.x, w.next()) {
      *reinterpret_cast<uint4*>(
          outs.row(w.p, static_cast<size_t>(t.s0 + w.s)) + t.d0 + w.c * 8) =
          *reinterpret_cast<const uint4*>(xs(cur) + (w.s * g.xr + w.p) * g.re +
                                          w.c * 8);
    }
  }
  cp_async_wait_all();
}

// Launch the backward on `stream`: `ns` samples by `dt` columns a unit, a
// persistent grid. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when a unit's stage exceeds a block's shared
// memory.
template <typename Rows, typename Outs>
int launch_bwd(const Rows& in, const Outs& outs, const float* d_acts, int f,
               int b, int d, int k, int ns, int dt, cudaStream_t stream) {
  const int npair = npair_of(f, k);
  if (b == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const BwdGeo g = bwd_geo(f, d, npair, ns, dt);
  if (g.smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = bwd_kernel<Rows, Outs>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, g.smem);
  }
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int64_t units = static_cast<int64_t>((b + ns - 1) / ns) * g.ndt;
  const int64_t fill = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(units < fill ? units : fill);
  kernel<<<grid, kThreads, g.smem, stream>>>(in, outs, d_acts, f, b, d, k,
                                             npair, g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The forward on the tensor cores
// ---------------------------------------------------------------------------
//
// Per sample, G = X X^T: X the F x D rows, staged with its rows padded to
// xr = 16 or 32 by zero rows (never stale memory: 0 * NaN is NaN). The
// product is mma.sync.m16n8k16 (bf16 in, f32 sums). One ldmatrix.x4 of a
// 16-row M tile of X is that tile's A fragment, and its two 8-row halves
// are at once the B fragments of the N tiles of the same rows (X^T in
// column-major order is X in row-major order), so one ldmatrix.x4 per M
// tile and k step feeds every product and each staged row is read from
// shared memory once per k step. Only the 16 x 8 output tiles that hold a
// pair of np.tril_indices(F, k) are issued (F = 27: 6 of 8, 48 MMAs a
// sample at D = 128). The epilogue rounds each wanted sum to bf16 into a
// [ns, P] f32 output stage at its pair's tril index, and the block writes
// the unit's ns * P outputs, one contiguous run, with 16-byte stores.
//
// Geometry (ops/cuda_interact.py: fwd_geometry): a unit is `ns` samples;
// its columns come in k tiles of up to kFwdMaxKTile, a multiple of 16 (D
// past the last multiple of 16 meets zero columns). A persistent grid of
// (blocks per SM) x SMs walks (unit, k tile) items, each block through a
// ring of kFwdStages stages filled by cp.async: while it computes one
// item, the next kFwdStages - 1 are in flight. A warp owns one sample and
// keeps its sums in registers across the unit's k tiles.
//
// Bound: F * D * 2 bytes in and P * 4 out per sample; the MMAs (2 * 6 *
// 16 * 8 * D flops a sample at F = 27, about 24 a byte moved) are far
// below the some 295 flops a byte at which the tensor cores would bound
// it, so device memory bounds the kernel.

// a ring of two stages leaves room for three blocks on an SM
// (ops/cuda_interact.py: FWD_SMEM_TARGET), which keeps more rows in flight
// than a deeper ring or larger units at fewer blocks an SM
constexpr int kFwdStages = 2;
constexpr int kFwdBlocksPerSm = 3;
constexpr int kFwdMaxKTile = 128;

struct FwdGeo {
  int xr;          // staged rows per sample: the MMA's M and N, 16 or 32
  int kt;          // columns per k tile: a multiple of 16
  int nkt;         // k tiles
  int re;          // bf16 elements per staged row: kt + 8
  int ns;          // samples per unit
  int npair;       // pairs per sample
  unsigned tiles;  // bit m * 4 + n: the 16 x 8 output tile (m, n) is issued
  size_t x_stage, o_stage, smem;
};

// the output tiles (m, n) that hold a pair (p, q), q <= p + k, p < f
inline unsigned fwd_tiles(int f, int k) {
  const int xr = f <= 16 ? 16 : 32;
  unsigned mask = 0;
  for (int m = 0; m < xr / 16; ++m) {
    const int pmax = f - 1 < m * 16 + 15 ? f - 1 : m * 16 + 15;
    for (int n = 0; n < xr / 8 && m * 16 <= pmax; ++n) {
      if (n * 8 <= pmax + k) {
        mask |= 1u << (m * 4 + n);
      }
    }
  }
  return mask;
}

inline FwdGeo fwd_geo(int f, int d, int k, int ns) {
  FwdGeo g;
  g.xr = f <= 16 ? 16 : 32;
  const int kd = (d + 15) / 16 * 16;
  g.kt = kd < kFwdMaxKTile ? kd : kFwdMaxKTile;
  g.nkt = (d + g.kt - 1) / g.kt;
  // a row stride of an odd number of 16-byte units: the eight rows of an
  // ldmatrix hit eight different bank quads
  g.re = g.kt + 8;
  g.ns = ns;
  g.npair = npair_of(f, k);
  g.tiles = fwd_tiles(f, k);
  g.x_stage = static_cast<size_t>(ns) * g.xr * g.re * sizeof(__nv_bfloat16);
  // the output block starts at its destination's offset mod 16 bytes
  g.o_stage = round16((static_cast<size_t>(ns) * g.npair + 4) * sizeof(float));
  g.smem = kFwdStages * g.x_stage + g.o_stage;
  return g;
}

inline bool args_ok(int f, int b, int d, int k, int samples_per_unit) {
  return f >= 1 && f <= kMaxParts && b >= 0 && d > 0 && d % 8 == 0 &&
         (k == 0 || k == -1) && samples_per_unit >= 1 &&
         samples_per_unit <= kThreads / 32;
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
fwd_kernel(Rows in, int f, int b, int d, int k, FwdGeo g,
           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto xs = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + i * g.x_stage);
  };
  float* const o_base =
      reinterpret_cast<float*>(smem_raw + kFwdStages * g.x_stage);

  // the pad rows [f, xr) of every stage's samples are zero for the whole
  // run: the loads write rows < f only
  const int pad = g.xr - f;
  if (pad > 0) {
    const int vpr = g.kt / 8;
    const int total = kFwdStages * g.ns * pad * vpr;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int c = i % vpr;
      const int r = i / vpr;
      const int sample = r / pad;  // stage * ns + sample
      *reinterpret_cast<uint4*>(
          xs(0) + (static_cast<size_t>(sample) * g.xr + f + r % pad) * g.re +
          c * 8) = zero;
    }
  }

  // this block's items: (unit blockIdx.x + i * gridDim.x, k tile t) for
  // item i * nkt + t
  const int n_units = (b + g.ns - 1) / g.ns;
  const int my_units =
      static_cast<int>(blockIdx.x) < n_units
          ? (n_units - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;
  const int n_items = my_units * g.nkt;
  const int last_dn = d - (g.nkt - 1) * g.kt;
  const RowWalk walk_full(threadIdx.x, kThreads, g.kt / 8, f);
  const RowWalk walk_last(threadIdx.x, kThreads, last_dn / 8, f);

  auto issue = [&](int item, __nv_bfloat16* x) {
    const int i = item / g.nkt;
    const int t = item - i * g.nkt;
    const int s0 = (blockIdx.x + i * gridDim.x) * g.ns;
    const int nsa = min(g.ns, b - s0);
    const int d0 = t * g.kt;
    const int dn = min(g.kt, d - d0);
    RowWalk w = dn == g.kt ? walk_full : walk_last;
    const int total = nsa * f * (dn / 8);
    for (int j = threadIdx.x; j < total; j += blockDim.x, w.next()) {
      cp_async16(x + (w.s * g.xr + w.p) * g.re + w.c * 8,
                 in.row(w.p, static_cast<size_t>(s0 + w.s)) + d0 + w.c * 8);
    }
    if (dn % 16 != 0) {
      // the k step past D reads these 8 columns: zeros, not a full tile's
      // stale columns
      for (int j = threadIdx.x; j < nsa * f; j += blockDim.x) {
        *reinterpret_cast<uint4*>(x + ((j / f) * g.xr + j % f) * g.re + dn) =
            zero;
      }
    }
  };

  for (int j = 0; j < kFwdStages - 1; ++j) {
    if (j < n_items) {
      issue(j, xs(j));
    }
    cp_async_commit();
  }
  float acc[2][4][4];
  const int gr = lane >> 2;
  const int c2 = 2 * (lane & 3);
  int cur = 0;
  for (int item = 0; item < n_items; ++item) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // this item's stage is in; the oldest one is free
    {
      const int next = item + kFwdStages - 1;
      const int slot = cur == 0 ? kFwdStages - 1 : cur - 1;
      if (next < n_items) {
        issue(next, xs(slot));
      }
      cp_async_commit();
    }
    const int i = item / g.nkt;
    const int t = item - i * g.nkt;
    const int s0 = (blockIdx.x + i * gridDim.x) * g.ns;
    const int nsa = min(g.ns, b - s0);
    const int dn = min(g.kt, d - t * g.kt);
    if (t == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][n][e] = 0.f;
          }
        }
      }
    }
    if (warp < nsa) {
      const __nv_bfloat16* xm =
          xs(cur) + (warp * g.xr + (lane & 15)) * g.re + (lane >> 4) * 8;
      const int ksteps = (dn + 15) / 16;
#pragma unroll 2
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a[2][4];
        ldmatrix_x4(a[0], xm + ks * 16);
        if (g.xr == 32) {
          ldmatrix_x4(a[1], xm + 16 * g.re + ks * 16);
        } else {
          a[1][0] = a[1][1] = a[1][2] = a[1][3] = 0u;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if ((g.tiles >> (m * 4 + n)) & 1u) {
              // B of N tile n: rows 8n .. 8n + 7, the A fragment's half
              mma_bf16(acc[m][n], a[m], a[n >> 1][n & 1],
                       a[n >> 1][(n & 1) + 2]);
            }
          }
        }
      }
    }
    if (t == g.nkt - 1) {
      float* const dst = out + static_cast<size_t>(s0) * g.npair;
      float* const os = o_base + phase_of(dst);
      if (warp < nsa) {
        float* const o = os + warp * g.npair;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            if ((g.tiles >> (m * 4 + n)) & 1u) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int p = m * 16 + gr + 8 * (e >> 1);
                const int q = n * 8 + c2 + (e & 1);
                if (p < f && q <= p + k) {
                  const int tri = (k == 0) ? p * (p + 1) / 2 : p * (p - 1) / 2;
                  o[tri + q] = __bfloat162float(
                      __float2bfloat16_rn(acc[m][n][e]));
                }
              }
            }
          }
        }
      }
      __syncthreads();
      // the unit's nsa * P outputs are one contiguous run: 4-byte stores
      // up to a 16-byte boundary, then 16-byte stores
      const int n = nsa * g.npair;
      const int head = min(n, (4 - phase_of(dst)) & 3);
      const int nvec = (n - head) / 4;
      for (int j = threadIdx.x; j < head; j += blockDim.x) {
        dst[j] = os[j];
      }
      for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
        *reinterpret_cast<float4*>(dst + head + 4 * j) =
            *reinterpret_cast<const float4*>(os + head + 4 * j);
      }
      for (int j = head + 4 * nvec + threadIdx.x; j < n; j += blockDim.x) {
        dst[j] = os[j];
      }
    }
    cur = cur + 1 == kFwdStages ? 0 : cur + 1;
  }
  cp_async_wait_all();
}

// Launch the forward on `stream`: `ns` samples a unit (ops/cuda_interact.py:
// fwd_geometry), a persistent grid. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue when a unit's stages exceed a block's
// shared memory.
template <typename Rows>
int launch_fwd(const Rows& in, int f, int b, int d, int k, int ns, float* out,
               cudaStream_t stream) {
  if (b == 0 || npair_of(f, k) == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const FwdGeo g = fwd_geo(f, d, k, ns);
  if (g.smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = fwd_kernel<Rows>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, g.smem);
  }
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int64_t units = (b + ns - 1) / ns;
  const int64_t fill = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(units < fill ? units : fill);
  kernel<<<grid, kThreads, g.smem, stream>>>(in, f, b, d, k, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace interact
