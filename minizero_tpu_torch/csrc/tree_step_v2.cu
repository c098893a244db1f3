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
// Design. One warp per game, four games per 128-thread block, no shared
// memory. The walk follows real indices: an action lane of the current
// node's cix row that holds a node index is that child, so one walk step
// reads one cix row (L = A + 8 ints), the prior row only where a lane has
// no child, and the visits / mean / pedge of the children that exist. The
// TPU kernel scanned the whole [cap] node vector (pvec == cur) per level,
// because a vector machine cannot chase a per-game pointer; a warp can. The
// actions are strided over the 32 lanes; each lane keeps its best candidate
// under the reference's order (larger score, then larger prior, then lower
// action) and a warp shuffle reduction merges them, so nothing is staged in
// shared memory. cap is a runtime argument and bounds the walk's depth.
//
// What bounds it. The least work is data-dependent: the leaf row written
// (L prior floats + L cix ints), the parent edge, the path nodes' visits
// and means read and written, and per walk level one cix row, the prior
// row and the children's three node floats: about 10 MB for B = 1024 late
// in an n = 200 search whose walks are chain-deep, a few microseconds at
// 3.35 TB/s. The arithmetic is a few operations per action per level. The
// real limit is latency: each level is a chain of dependent loads (cix row
// -> child stats -> reduction -> next row), and a random-init network makes
// walks chain-deep (the deepest of 1024 games reached 164 levels at
// simulation 190 of an n = 200 search, chip_smoke.py), so a launch costs
// about (deepest walk) x (one dependent round trip); the 1024 warps in
// flight hide each other's loads only while walks are of similar depth.
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

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

__device__ __forceinline__ Best warp_best(Best v) {
  for (int o = 16; o > 0; o >>= 1) {
    Best w;
    w.score = __shfl_xor_sync(kFull, v.score, o);
    w.tb = __shfl_xor_sync(kFull, v.tb, o);
    w.act = __shfl_xor_sync(kFull, v.act, o);
    if (better(w, v)) v = w;
  }
  return v;
}

__device__ __forceinline__ void offer(Best& v, float score, float tb, int act) {
  const Best c{score, tb, act};
  if (better(c, v)) v = c;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tree_step_v2_kernel(const Args p) {
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
  uint8_t* npath = p.npath + (size_t)b * cap;

  // ---- 1. expand row s and write the parent's edge ------------------------
  const bool snew = p.snew[b] != 0;
  const bool lt = p.lterm[b] != 0;
  if (en && snew) {
    const int sp = p.sparent[b], sa = p.saction[b];
    float* prow = prior + (size_t)s * L;
    int* crow = cix + (size_t)s * L;
    for (int l = lane; l < L; l += 32) {
      float pv = 0.0f;
      int cv = -2;
      if (l < A) {
        const bool live = p.llegal[(size_t)b * A + l] != 0 && !lt;
        if (live) { pv = p.lpolicy[(size_t)b * A + l]; cv = -1; }
      } else if (l == A) {
        cv = sp;
      } else if (l == A + 1) {
        cv = sa;
      } else if (l == A + 2) {
        cv = p.lturn[b];
      } else if (l == A + 3) {
        cv = lt ? 0 : 1;
      } else if (l == A + 4) {
        cv = lt ? 1 : 0;
      }
      prow[l] = pv;
      crow[l] = cv;
    }
    if (lane == 0) {
      p.pvec[(size_t)b * cap + s] = sp;
      p.avec[(size_t)b * cap + s] = sa;
      p.pterm[(size_t)b * cap + s] = lt ? 1 : 0;
      pedge[s] = p.sprior[b];
      value[s] = p.lvalue[b];
      cix[(size_t)sp * L + sa] = lt ? -3 - s : s;
    }
  }
  __syncwarp();

  // ---- 2. back up along the path plus the start node ----------------------
  if (en) {
    const int start = snew ? s : max(p.sleaf[b], 0);
    const float v = snew ? p.lvalue[b] : value[start];
    const uint8_t* spath = p.spath + (size_t)b * cap;
    for (int n = lane; n < cap; n += 32) {
      if (spath[n] != 0 || n == start) {
        const float c = vis[n] + 1.0f;
        vis[n] = c;
        mean[n] = mean[n] + (v - mean[n]) / fmaxf(c, 1.0f);
      }
    }
  }
  for (int n = lane; n < cap; n += 32) npath[n] = 0;
  __syncwarp();

  // ---- 3. PUCT walk from the root -----------------------------------------
  int cur = 0;
  float curvis = vis[0];
  int sel_parent = 0, sel_action = 0, sel_leaf = -1;
  bool sel_new = false;
  float sel_prior = 0.0f;
  for (int depth = 0; depth < cap; ++depth) {
    const int* crow = cix + (size_t)cur * L;
    const float* prow = prior + (size_t)cur * L;
    const bool flip = p.flip && crow[A + 2] == 2;
    const float total = curvis - 1.0f;
    const float bias = p.puct_init + logf((1.0f + total + p.puct_base) / p.puct_base);
    const float sq = sqrtf(fmaxf(total, 0.0f));
    // children that exist: their q (for init-Q and their own score)
    Best best{0.0f, 0.0f, -1};
    double sum_q = 0.0;
    int nv = 0;
    for (int a = lane; a < A; a += 32) {
      const int c = crow[a];
      if (c >= 0 || c <= -3) {
        const int child = c >= 0 ? c : -3 - c;
        float q = mean[child];
        if (flip) q = -q;
        sum_q += (double)q;
        nv += 1;
        const float pe = pedge[child];
        const float u = bias * pe * sq / (1.0f + vis[child]);
        offer(best, q + u, pe, a);
      }
    }
    const float sqf = (float)warp_sum(sum_q);
    const float nvf = (float)warp_sum(nv);
    float init_q;
    if (p.init_q_average) init_q = nvf > 0.0f ? sqf / fmaxf(nvf, 1.0f) : 1.0f;
    else init_q = (sqf - 1.0f) / (nvf + 1.0f);
    // legal actions with no child yet
    for (int a = lane; a < A; a += 32) {
      if (crow[a] == -1) {
        const float pr = prow[a];
        offer(best, init_q + bias * pr * sq, pr, a);
      }
    }
    best = warp_best(best);
    const int act = best.act < 0 ? 0 : best.act;  // a node always has a legal action
    const int c = crow[act];
    if (lane == 0) npath[cur] = 1;
    if (c == -1 || c <= -3) {
      sel_parent = cur;
      sel_action = act;
      sel_new = c == -1;
      sel_leaf = sel_new ? -1 : -3 - c;
      sel_prior = best.tb;
      if (!sel_new && lane == 0) npath[sel_leaf] = 1;
      break;
    }
    cur = c;
    curvis = vis[c];
  }

  if (lane == 0) {
    p.nparent[b] = sel_parent;
    p.naction[b] = sel_action;
    p.nleaf[b] = sel_leaf;
    p.nnew[b] = sel_new ? 1 : 0;
    p.nprior[b] = sel_prior;
  }
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

  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tree_step_v2_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
