// Large-N fused MCTS tree step on node-indexed packed trees (Hopper,
// sm_90a). Replaces the Pallas TPU kernel
// minizero_tpu/ops/tree_kernel_v2.py::_tree_step_kernel_v2 (wrapper
// fused_tree_step_v2): plain AlphaZero PUCT, think_batch 1, no Gumbel,
// discount 1, no in-tree rewards, no value rescale. Its contract is
// minizero_tpu_torch/ops/tree_kernel_v2.py::tree_step_v2_reference:
//
//   1. expand the new leaf at row s (prior and cix rows, node scalars in the
//      spare lanes and the node vectors) and write the parent's edge lane
//      (s, or -3 - s for a terminal leaf);
//   2. back up the leaf value (the stored value of a revisited leaf) along
//      the previous selection's path mask plus the start node;
//   3. walk PUCT from the root to the next leaf: an unmaterialised legal
//      action (new edge) or a terminal child (revisit);
//   4. write the next selection (parent, action, leaf, is_new, path, prior).
//   phase == 0 runs steps 3-4 only.
//
// What bounds it. The least work is data-dependent: the leaf row written,
// the path nodes' statistics read and written, and per walk level one cix
// row, the prior of its open lanes and the three statistics of each child:
// about 10 MB for B = 1024 late in an n = 200 search whose walks are
// chain-deep, a few microseconds at 3.35 TB/s, and a few operations per
// action per level. The real limit is latency: a walk level cannot start
// before the level above has chosen its child, a random-init network makes
// walks chain-deep (164 levels at simulation 190 of an n = 200 search), and
// a launch lasts as long as the deepest walk of the batch. There is no
// matrix product anywhere, so the tensor cores (wgmma) and TMA tile rings
// have nothing to do here; the design spends its effort on the length of
// one level's dependent chain instead.
//
// Design. One warp per game, four games per 128-thread block; action a of
// a row lives in lane a % 32, slot a / 32 (K = ceil(A / 32) slots, a
// template argument, so a row sits in registers).
//   - Every load that depends on nothing else (the selection, the leaf's
//     inputs, the stored value of a revisited leaf, the root's row, the node
//     statistics and the previous path) is issued at the start, together;
//     the expansion's edge into the root is patched into the root's row in
//     registers.
//   - Shared memory holds each game's node statistics (visits, mean, pedge:
//     3 * cap floats), its nodes' PUCT factors (2 * cap floats) and the path
//     mask (cap bytes), loaded with coalesced loads at the start; the backup
//     updates the shared copies and writes back only the path nodes, and the
//     walk reads every child's statistics from shared memory. Dynamic in
//     cap: 16,896 bytes per block at cap 201.
//   - Right after the backup, the rows (cix and prior) of every node on the
//     previous selection's path are prefetched into L2 with Hopper's bulk
//     prefetch (cp.async.bulk.prefetch.L2, 16-byte aligned), spread over the
//     lanes: deep walks re-follow most of the previous path, so their levels
//     meet L2 hits instead of device-memory misses.
//   - A level's cix row, prior row and player lane are loaded together (the
//     prior row does not depend on the cix row), once.
//   - One pass over the actions: each lane keeps its best child and its
//     open lane (cix == -1) of largest prior. All open lanes share init_q,
//     and init_q + (bias * prior) * sq is non-decreasing in the prior when
//     bias >= 0 and sq >= 0 (rounding is monotone), so the open lane of
//     largest prior (ties to the lower action) is the best open candidate
//     under the reference's order; its score is computed once after the
//     init-Q reduction and compared with the best child.
//   - The best child is known before init_q, and when the walk descends it
//     descends into that child; so its row is loaded right away, and the
//     load overlaps the init-Q reduction and the final comparison.
//   - The PUCT factors of every node (bias = c1 + log((1 + n + c2) / c2) and
//     sqrt(n), n its visits less one) are computed once after the backup,
//     lanes in parallel, into shared memory: a level reads two numbers
//     instead of running logf and sqrtf on its own chain.
//   - Reductions: the child count with __reduce_add_sync; each argmax with
//     __reduce_max_sync on an order-preserving 32-bit key of the score, then
//     of the tie-break prior among the lanes holding the best score, then
//     __reduce_min_sync on the action. The key maps -0.0 and +0.0 to one
//     value, as the reference's float comparisons do.
//
// Numerics. Built with --fmad=false and IEEE logf/sqrtf/division, so that
// each multiply and add rounds as the plain PyTorch version's separate
// operations do, in the same order: ((bias * prior) * sqrt(n)) / (1 + n_c)
// plus q. The sum of the children's q is accumulated in double and rounded
// once (as the plain version does). Integer outputs then match exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoAction = 0xffffffffu;

struct Args {
  int B, cap, A, L, s, phase, flip, init_q_average;
  float puct_base, puct_init;
  // packed trees, updated in place
  float* prior;  // [B, cap, L]
  int* cix;      // [B, cap, L]
  float *visits, *mean, *value, *pedge;  // [B, cap]
  int *pvec, *avec, *pterm;              // [B, cap]
  // this simulation's selection and its evaluated leaf
  const int *sparent, *saction, *sleaf;  // [B]
  const uint8_t* snew;                   // [B]
  const uint8_t* spath;                  // [B, cap]
  const float* sprior;                   // [B]
  const float* lpolicy;                  // [B, A]
  const uint8_t* llegal;                 // [B, A]
  const uint8_t* lterm;                  // [B]
  const float* lvalue;                   // [B]
  const int* lturn;                      // [B]
  // next selection
  int *nparent, *naction, *nleaf;  // [B]
  uint8_t* nnew;                   // [B]
  uint8_t* npath;                  // [B, cap]
  float* nprior;                   // [B]
};

// shared memory of one warp: visits, mean, pedge, PUCT bias and sqrt(n)
// [cap] floats, path [cap] bytes
__host__ __device__ inline int warp_smem_floats(int cap) { return 5 * cap + (cap + 3) / 4; }

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Order-preserving key: x < y <=> key(x) < key(y) for non-NaN floats, and
// key(-0.0) == key(+0.0). Every real key is above 0, which marks "none".
__device__ __forceinline__ unsigned fkey(float x) {
  const unsigned u = __float_as_uint(x);
  return x < 0.0f ? ~u : (u & 0x7fffffffu) | 0x80000000u;
}

// The candidate order of the reference's PUCT argmax: a larger score wins,
// then a larger tie-break prior, then a lower action. `act` < 0 marks "no
// candidate yet".
struct Best {
  float score, tb;
  int act;
};

__device__ __forceinline__ bool better(const Best& x, const Best& y) {
  if (x.act < 0) return false;
  if (y.act < 0) return true;
  if (x.score != y.score) return x.score > y.score;
  if (x.tb != y.tb) return x.tb > y.tb;
  return x.act < y.act;
}

// The warp's best candidate under `better`; every lane gets it. The winner
// is the lane that holds its action (a % 32), so score and tb come from it.
__device__ __forceinline__ Best warp_best(const Best& v) {
  const unsigned ks = v.act >= 0 ? fkey(v.score) : 0u;
  const unsigned kmax = __reduce_max_sync(kFull, ks);
  const unsigned kt = (v.act >= 0 && ks == kmax) ? fkey(v.tb) : 0u;
  const unsigned tmax = __reduce_max_sync(kFull, kt);
  const unsigned ka = (v.act >= 0 && ks == kmax && kt == tmax) ? (unsigned)v.act : kNoAction;
  const unsigned amin = __reduce_min_sync(kFull, ka);
  if (amin == kNoAction) return Best{0.0f, 0.0f, -1};
  const int src = (int)(amin & 31u);
  return Best{__shfl_sync(kFull, v.score, src), __shfl_sync(kFull, v.tb, src), (int)amin};
}

// slot `k` of a register row, for a k known only at run time
template <int K, typename T>
__device__ __forceinline__ T pick(const T (&row)[K], int k) {
  T out = row[0];
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (j == k) out = row[j];
  return out;
}

// One node's row in registers: lane's actions a = lane + 32 k.
template <int K>
struct Row {
  int c[K];
  float pr[K];
  int turn;
};

template <int K>
__device__ __forceinline__ void load_row(Row<K>& r, const int* crow, const float* prow, int A,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane + 32 * k;
    r.c[k] = a < A ? crow[a] : -2;
    r.pr[k] = a < A ? prow[a] : 0.0f;
  }
  r.turn = crow[A + 2];
}

// Bulk-prefetch [p, p + bytes) into L2, widened to 16-byte alignment.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  const size_t g = __cvta_generic_to_global(p);
  const size_t lo = g & ~(size_t)15;
  const size_t hi = (g + (size_t)bytes + 15) & ~(size_t)15;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(lo), "r"((unsigned)(hi - lo)) : "memory");
}

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tree_step_v2_kernel(const Args p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= p.B) return;  // whole warp: b is uniform across its lanes

  const int cap = p.cap, A = p.A, L = p.L, s = p.s;
  const bool en = p.phase > 0;
  float* prior = p.prior + (size_t)b * cap * L;
  int* cix = p.cix + (size_t)b * cap * L;
  float* vis = p.visits + (size_t)b * cap;
  float* mean = p.mean + (size_t)b * cap;
  float* value = p.value + (size_t)b * cap;
  float* pedge = p.pedge + (size_t)b * cap;
  float* s_vis = smem + (size_t)warp * warp_smem_floats(cap);
  float* s_mean = s_vis + cap;
  float* s_pedge = s_mean + cap;
  float* s_bias = s_pedge + cap;
  float* s_sq = s_bias + cap;
  uint8_t* s_path = reinterpret_cast<uint8_t*>(s_sq + cap);

  // ---- 0. every load that depends on nothing else, issued together: the
  // selection, the leaf, the root's row, then the node statistics into
  // shared memory ----------------------------------------------------------
  const bool snew = p.snew[b] != 0;
  const bool lt = p.lterm[b] != 0;
  const int sp = p.sparent[b], sa = p.saction[b], sleaf = p.sleaf[b], lturn = p.lturn[b];
  const float lvalue = p.lvalue[b], sprior = p.sprior[b];
  // the backed-up value: the leaf's, or the stored value of a revisited node
  const float v_up = (en && !snew) ? value[max(sleaf, 0)] : lvalue;
  const uint8_t* spath = p.spath + (size_t)b * cap;
  float lpol[K];
  bool llive[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane + 32 * k;
    llive[k] = en && a < A && p.llegal[(size_t)b * A + a] != 0;
    lpol[k] = en && a < A ? p.lpolicy[(size_t)b * A + a] : 0.0f;
  }
  Row<K> row;  // the root's; the expansion may write one of its lanes
  load_row(row, cix, prior, A, lane);
  // s_path holds the previous path until the backup has read it
  for (int n0 = 0; n0 < cap; n0 += 4 * 32) {
    float v[4], m[4], e[4];
    uint8_t on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      v[j] = n < cap ? vis[n] : 0.0f;
      m[j] = n < cap ? mean[n] : 0.0f;
      e[j] = n < cap ? pedge[n] : 0.0f;
      on[j] = en && n < cap ? spath[n] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      if (n < cap) {
        s_vis[n] = v[j];
        s_mean[n] = m[j];
        s_pedge[n] = e[j];
        s_path[n] = on[j];
      }
    }
  }

  // ---- 1. expand row s and write the parent's edge ------------------------
  if (en && snew) {
    float* prow = prior + (size_t)s * L;
    int* crow = cix + (size_t)s * L;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      if (a < A) {
        const bool live = llive[k] && !lt;
        prow[a] = live ? lpol[k] : 0.0f;
        crow[a] = live ? -1 : -2;
      }
    }
    for (int l = A + lane; l < L; l += 32) {
      int cv = -2;
      if (l == A) cv = sp;
      else if (l == A + 1) cv = sa;
      else if (l == A + 2) cv = lturn;
      else if (l == A + 3) cv = lt ? 0 : 1;
      else if (l == A + 4) cv = lt ? 1 : 0;
      prow[l] = 0.0f;
      crow[l] = cv;
    }
    const int enc = lt ? -3 - s : s;
    if (lane == 0) {
      p.pvec[(size_t)b * cap + s] = sp;
      p.avec[(size_t)b * cap + s] = sa;
      p.pterm[(size_t)b * cap + s] = lt ? 1 : 0;
      pedge[s] = sprior;
      s_pedge[s] = sprior;
      value[s] = lvalue;
      cix[(size_t)sp * L + sa] = enc;
    }
    if (sp == 0 && lane == (sa & 31)) {  // the edge lies in the root's row
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == (sa >> 5)) row.c[k] = enc;
    }
  }
  __syncwarp();
  if (en && snew && s == 0) load_row(row, cix, prior, A, lane);  // the root rewritten

  // ---- 2. back up along the path plus the start node, and prefetch the
  // rows of the path into L2 ---------------------------------------------------
  if (en) {
    const int start = snew ? s : max(sleaf, 0);
    const float v = v_up;
    for (int n = lane; n < cap; n += 32) {
      const bool on_path = s_path[n] != 0;
      s_path[n] = 0;
      if (on_path) {
        prefetch_l2(cix + (size_t)n * L, L * 4);
        prefetch_l2(prior + (size_t)n * L, L * 4);
      }
      if (on_path || n == start) {
        const float c = s_vis[n] + 1.0f;
        const float m = s_mean[n] + (v - s_mean[n]) / fmaxf(c, 1.0f);
        s_vis[n] = c;
        s_mean[n] = m;
        vis[n] = c;
        mean[n] = m;
      }
    }
  }
  __syncwarp();

  // ---- 3. PUCT walk from the root -----------------------------------------
  // the PUCT factors of every node: bias and sqrt of its visits less one
  for (int n = lane; n < cap; n += 32) {
    const float total = s_vis[n] - 1.0f;
    s_bias[n] = p.puct_init + logf((1.0f + total + p.puct_base) / p.puct_base);
    s_sq[n] = sqrtf(fmaxf(total, 0.0f));
  }
  __syncwarp();
  int cur = 0;
  int sel_parent = 0, sel_action = 0, sel_leaf = -1;
  bool sel_new = false;
  float sel_prior = 0.0f;
  for (int depth = 0; depth < cap; ++depth) {
    const bool flip = p.flip && row.turn == 2;
    const float bias = s_bias[cur], sq = s_sq[cur];
    if (lane == 0) s_path[cur] = 1;
    // one pass: the lane's best child, its open lane of largest prior, and
    // its share of the children's q
    Best child{0.0f, 0.0f, -1};
    float open_pr = 0.0f;
    int open_act = -1;
    double sum_q = 0.0;
    int nv = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      const int c = row.c[k];
      if (c >= 0 || c <= -3) {
        const int ch = c >= 0 ? c : -3 - c;
        float q = s_mean[ch];
        if (flip) q = -q;
        sum_q += (double)q;
        nv += 1;
        const float pe = s_pedge[ch];
        const float u = bias * pe * sq / (1.0f + s_vis[ch]);
        const Best cand{q + u, pe, a};
        if (better(cand, child)) child = cand;
      } else if (c == -1 && (open_act < 0 || row.pr[k] > open_pr)) {
        open_pr = row.pr[k];
        open_act = a;
      }
    }
    // the best child, and its row on its way before init-Q is known
    child = warp_best(child);
    int child_c = -2;
    if (child.act >= 0)
      child_c = __shfl_sync(kFull, pick(row.c, child.act >> 5), child.act & 31);
    Row<K> next;
    const int nx = child_c >= 0 ? child_c : cur;
    load_row(next, cix + (size_t)nx * L, prior + (size_t)nx * L, A, lane);
    // the best open lane: largest prior, then lowest action
    const unsigned kp = open_act >= 0 ? fkey(open_pr) : 0u;
    const unsigned kpmax = __reduce_max_sync(kFull, kp);
    const unsigned open_min = __reduce_min_sync(
        kFull, (open_act >= 0 && kp == kpmax) ? (unsigned)open_act : kNoAction);
    const float sqf = (float)warp_sum(sum_q);
    const float nvf = (float)__reduce_add_sync(kFull, (unsigned)nv);
    float init_q;
    if (p.init_q_average) init_q = nvf > 0.0f ? sqf / fmaxf(nvf, 1.0f) : 1.0f;
    else init_q = (sqf - 1.0f) / (nvf + 1.0f);
    Best best = child;
    int c = child_c;
    if (open_min != kNoAction) {
      const int oa = (int)open_min;
      const float opr = __shfl_sync(kFull, open_pr, oa & 31);
      const Best open{init_q + bias * opr * sq, opr, oa};
      if (better(open, best)) {
        best = open;
        c = -1;
      }
    }
    int act = best.act;
    float tb = best.tb;
    if (act < 0) {  // no candidate at all: the reference's argmax gives A - 1
      act = A - 1;
      tb = -INFINITY;
      c = __shfl_sync(kFull, pick(row.c, act >> 5), act & 31);
    }
    if (c == -1 || c <= -3) {
      sel_parent = cur;
      sel_action = act;
      sel_new = c == -1;
      sel_leaf = sel_new ? -1 : -3 - c;
      sel_prior = tb;
      if (!sel_new && lane == 0) s_path[sel_leaf] = 1;
      break;
    }
    // a child (c >= 0), or no candidate at all (c == -2): the reference
    // then clamps to the root
    cur = max(c, 0);
    if (cur == nx) row = next;  // already on its way
    else load_row(row, cix + (size_t)cur * L, prior + (size_t)cur * L, A, lane);
  }
  __syncwarp();

  uint8_t* npath = p.npath + (size_t)b * cap;
  for (int n = lane; n < cap; n += 32) npath[n] = s_path[n];
  if (lane == 0) {
    p.nparent[b] = sel_parent;
    p.naction[b] = sel_action;
    p.nleaf[b] = sel_leaf;
    p.nnew[b] = sel_new ? 1 : 0;
    p.nprior[b] = sel_prior;
  }
}

using KernelFn = void (*)(const Args);

// the instantiation for A actions: K = ceil(A / 32) slots, rounded up to
// one of the compiled sizes; nullptr above 12 slots (A > 384)
KernelFn kernel_for(int A) {
  const int k = (A + 31) / 32;
  if (k <= 1) return tree_step_v2_kernel<1>;
  if (k == 2) return tree_step_v2_kernel<2>;
  if (k == 3) return tree_step_v2_kernel<3>;
  if (k == 4) return tree_step_v2_kernel<4>;
  if (k <= 8) return tree_step_v2_kernel<8>;
  if (k <= 12) return tree_step_v2_kernel<12>;
  return nullptr;
}

size_t dynamic_smem(int cap) {
  return (size_t)kWarpsPerBlock * warp_smem_floats(cap) * sizeof(float);
}

}  // namespace

extern "C" int tree_step_v2_launch(
    int B, int cap, int A, int L, int s, int phase, int flip, int init_q_average,
    float puct_base, float puct_init,
    void* prior, void* cix, void* visits, void* mean, void* value, void* pedge,
    void* pvec, void* avec, void* pterm,
    void* sparent, void* saction, void* sleaf, void* snew, void* spath, void* sprior,
    void* lpolicy, void* llegal, void* lterm, void* lvalue, void* lturn,
    void* nparent, void* naction, void* nleaf, void* nnew, void* npath, void* nprior,
    void* stream) {
  if (B == 0) return 0;
  const KernelFn kernel = kernel_for(A);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  Args p;
  p.B = B; p.cap = cap; p.A = A; p.L = L; p.s = s; p.phase = phase;
  p.flip = flip; p.init_q_average = init_q_average;
  p.puct_base = puct_base; p.puct_init = puct_init;
  p.prior = (float*)prior; p.cix = (int*)cix;
  p.visits = (float*)visits; p.mean = (float*)mean; p.value = (float*)value;
  p.pedge = (float*)pedge;
  p.pvec = (int*)pvec; p.avec = (int*)avec; p.pterm = (int*)pterm;
  p.sparent = (const int*)sparent; p.saction = (const int*)saction;
  p.sleaf = (const int*)sleaf; p.snew = (const uint8_t*)snew;
  p.spath = (const uint8_t*)spath; p.sprior = (const float*)sprior;
  p.lpolicy = (const float*)lpolicy; p.llegal = (const uint8_t*)llegal;
  p.lterm = (const uint8_t*)lterm; p.lvalue = (const float*)lvalue;
  p.lturn = (const int*)lturn;
  p.nparent = (int*)nparent; p.naction = (int*)naction; p.nleaf = (int*)nleaf;
  p.nnew = (uint8_t*)nnew; p.npath = (uint8_t*)npath; p.nprior = (float*)nprior;

  const size_t smem = dynamic_smem(cap);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<blocks, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block of the
// kernel that a launch with A actions and capacity cap runs.
extern "C" int tree_step_v2_attributes(int A, int cap, int* regs, int* static_smem,
                                       int* dynamic_smem_bytes) {
  const KernelFn kernel = kernel_for(A);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem_bytes = (int)dynamic_smem(cap);
  return 0;
}
