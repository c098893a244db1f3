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
// Above 384 actions (12 slots; clobber 400, amazons 3040) a row no longer
// fits a lane's registers, and kernel_for hands out the wide kernel
// (tree_step_v2_wide_kernel), whose contract and order of operations are the
// register kernel's; both call the same helpers for every per-action stage
// (the node's expansion, backup, PUCT factors, a level's candidates,
// settling the selection), and only the reductions have block-wide
// versions. Its design:
//   - One block per game, W warps (wide_warps: ceil(A / 384), at least 2,
//     at most 8; more warps a game measured slower on Clobber's deep walks),
//     so that B = 1024 games fill the card; action a is handled by thread
//     a % 32W, so a warp's lane holds a % 32 as in the register kernel.
//   - A walked node's cix row (all L = A + 8 lanes, the player lane among
//     them) and prior row are staged in shared memory by Hopper's bulk
//     copies (cp.async.bulk global -> shared on an mbarrier, issued by
//     thread 0), in one of two buffers. A row starts at node * L * 4 bytes,
//     16-byte aligned only when A % 4 == 0: the copy takes the aligned
//     window around the row and the row is read at its offset inside it.
//     The root's rows are on their way at the start, and the expansion's
//     edge into the root is patched into the staged row.
//   - Before the backup, warp 0 notes for every node of the previous path
//     (parent pointers in shared memory) its successor on that path. A level
//     stages the successor of its node into the other buffer before its
//     pass, so that the copy overlaps the pass and the reduction while the
//     walk re-follows the previous path, as a deep walk mostly does; a walk
//     that goes elsewhere waits out that copy and stages its node. A parity
//     wait cannot tell a phase from the one two ahead, so every thread
//     waits every phase, and a barrier separates the last wait on a buffer
//     from its next copy.
//   - One barrier a level: each warp reduces its lanes (the best child and
//     its edge lane, the open lane of largest prior, the double sum of q and
//     the count), lane 0 writes the warp's share, one __syncthreads, and
//     every thread combines the W shares in order (the same order as the
//     warp reductions, the sums in a fixed order), so that every thread
//     holds the level's result and nobody reads the row after the barrier.
//     The shares alternate between two sets of slots, so that a warp that
//     runs ahead never overwrites a share that another is still reading.
//   - The node statistics, the backup (warp 0) and the PUCT factors (each
//     warp a slice of the nodes) are the register kernel's. Shared memory
//     per block (WideLayout): two buffers of 2 * window(4L) bytes, where
//     window(x) = 16 * ceil((x + 15) / 16), the node statistics 28 cap + cap
//     bytes and 96 W bytes of slots: 8.3 KB at A = 400, cap 51. The
//     launcher refuses a shape past the opt-in 227 KB (at A = 400 above
//     capacity 7,780) with kShapeTooLarge, which the wrapper raises as a
//     ValueError.
//   - The expansion writes its rows with plain stores, in 16-byte vectors
//     where A % 4 == 0; a walk may stage a row written in this step (the new
//     leaf's, or its parent's edge), so the writers fence the generic proxy
//     against the async one (fence.proxy.async.global) before the barrier
//     that precedes every bulk copy of a walked row.
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

// ---- the stages that do not touch a row, shared by both kernels ----------

// One game's slices of the packed trees in device memory.
struct Game {
  float* prior;                          // [cap, L]
  int* cix;                              // [cap, L]
  float *vis, *mean, *value, *pedge;     // [cap]
  const uint8_t* spath;                  // [cap]
};

__device__ __forceinline__ Game game_of(const Args& p, int b) {
  const size_t cap = p.cap, L = p.L;
  return Game{p.prior + b * cap * L, p.cix + b * cap * L, p.visits + b * cap, p.mean + b * cap,
              p.value + b * cap, p.pedge + b * cap, p.spath + b * cap};
}

// A game's node statistics in its warp's shared memory (warp_smem_floats).
struct Nodes {
  float *vis, *mean, *pedge, *bias, *sq;
  uint8_t* path;
};

__device__ __forceinline__ Nodes nodes_of(float* smem, int warp, int cap) {
  float* base = smem + (size_t)warp * warp_smem_floats(cap);
  return Nodes{base, base + cap, base + 2 * cap, base + 3 * cap, base + 4 * cap,
               reinterpret_cast<uint8_t*>(base + 5 * cap)};
}

// The node statistics (and the previous path, until the backup has read
// it) into shared memory, four loads a lane issued together.
__device__ __forceinline__ void load_nodes(const Game& g, const Nodes& sh, int cap, bool en,
                                           int lane) {
  for (int n0 = 0; n0 < cap; n0 += 4 * 32) {
    float v[4], m[4], e[4];
    uint8_t on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      v[j] = n < cap ? g.vis[n] : 0.0f;
      m[j] = n < cap ? g.mean[n] : 0.0f;
      e[j] = n < cap ? g.pedge[n] : 0.0f;
      on[j] = en && n < cap ? g.spath[n] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      if (n < cap) {
        sh.vis[n] = v[j];
        sh.mean[n] = m[j];
        sh.pedge[n] = e[j];
        sh.path[n] = on[j];
      }
    }
  }
}

// Row s's spare lanes (the node scalars) and, on lane 0, the node vectors
// and the parent's edge lane `enc` (s, or -3 - s for a terminal leaf); the
// action lanes are the kernels' own.
__device__ __forceinline__ void expand_node(const Args& p, const Game& g, const Nodes& sh, int b,
                                            int s, int sp, int sa, int lturn, bool lt, int enc,
                                            float lvalue, float sprior, int lane) {
  const int A = p.A, L = p.L, cap = p.cap;
  float* prow = g.prior + (size_t)s * L;
  int* crow = g.cix + (size_t)s * L;
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
  if (lane == 0) {
    p.pvec[(size_t)b * cap + s] = sp;
    p.avec[(size_t)b * cap + s] = sa;
    p.pterm[(size_t)b * cap + s] = lt ? 1 : 0;
    g.pedge[s] = sprior;
    sh.pedge[s] = sprior;
    g.value[s] = lvalue;
    g.cix[(size_t)sp * L + sa] = enc;
  }
}

// Step 2: back up v along the path plus the start node, and prefetch the
// rows of the path into L2.
__device__ __forceinline__ void backup(const Game& g, const Nodes& sh, int cap, int L, int start,
                                       float v, int lane) {
  for (int n = lane; n < cap; n += 32) {
    const bool on_path = sh.path[n] != 0;
    sh.path[n] = 0;
    if (on_path) {
      prefetch_l2(g.cix + (size_t)n * L, L * 4);
      prefetch_l2(g.prior + (size_t)n * L, L * 4);
    }
    if (on_path || n == start) {
      const float c = sh.vis[n] + 1.0f;
      const float m = sh.mean[n] + (v - sh.mean[n]) / fmaxf(c, 1.0f);
      sh.vis[n] = c;
      sh.mean[n] = m;
      g.vis[n] = c;
      g.mean[n] = m;
    }
  }
}

// The PUCT factors of every node: bias and sqrt of its visits less one.
__device__ __forceinline__ void puct_factors(const Args& p, const Nodes& sh, int cap, int lane) {
  for (int n = lane; n < cap; n += 32) {
    const float total = sh.vis[n] - 1.0f;
    sh.bias[n] = p.puct_init + logf((1.0f + total + p.puct_base) / p.puct_base);
    sh.sq[n] = sqrtf(fmaxf(total, 0.0f));
  }
}

// One walk level. take() sees the node's actions one at a time, each lane
// its own: the lane's best child, its open lane (cix == -1) of largest
// prior, and its share of the children's q. `prior_of` reads the action's
// prior, needed for open lanes only.
struct Level {
  Best child{0.0f, 0.0f, -1};
  float open_pr = 0.0f;
  int open_act = -1;
  double sum_q = 0.0;
  int nv = 0;

  template <class P>
  __device__ __forceinline__ void take(const Nodes& sh, int a, int c, P prior_of, bool flip,
                                       float bias, float sq) {
    if (c >= 0 || c <= -3) {
      const int ch = c >= 0 ? c : -3 - c;
      float q = sh.mean[ch];
      if (flip) q = -q;
      sum_q += (double)q;
      nv += 1;
      const float pe = sh.pedge[ch];
      const float u = bias * pe * sq / (1.0f + sh.vis[ch]);
      const Best cand{q + u, pe, a};
      if (better(cand, child)) child = cand;
    } else if (c == -1) {
      const float pr = prior_of();
      if (open_act < 0 || pr > open_pr) {
        open_pr = pr;
        open_act = a;
      }
    }
  }

  // The level's best candidate (act < 0: none), once `child` holds the
  // warp's best child: that child, or the open lane of largest prior (then
  // lowest action) if it scores higher with init-Q, and then `c` becomes -1.
  __device__ __forceinline__ Best choose(bool init_q_average, float bias, float sq,
                                         int& c) const {
    const unsigned kp = open_act >= 0 ? fkey(open_pr) : 0u;
    const unsigned kpmax = __reduce_max_sync(kFull, kp);
    const unsigned open_min = __reduce_min_sync(
        kFull, (open_act >= 0 && kp == kpmax) ? (unsigned)open_act : kNoAction);
    const float sqf = (float)warp_sum(sum_q);
    const float nvf = (float)__reduce_add_sync(kFull, (unsigned)nv);
    float init_q;
    if (init_q_average) init_q = nvf > 0.0f ? sqf / fmaxf(nvf, 1.0f) : 1.0f;
    else init_q = (sqf - 1.0f) / (nvf + 1.0f);
    Best best = child;
    if (open_min != kNoAction) {
      const int oa = (int)open_min;
      const float opr = __shfl_sync(kFull, open_pr, oa & 31);
      const Best open{init_q + bias * opr * sq, opr, oa};
      if (better(open, best)) {
        best = open;
        c = -1;
      }
    }
    return best;
  }
};

// The next selection.
struct Sel {
  int parent = 0, action = 0, leaf = -1;
  bool is_new = false;
  float prior = 0.0f;
};

// The walk took action `act` (tie-break prior `tb`) at `cur`, whose edge
// there is `c`: a new edge (-1) or a terminal child (<= -3) ends it, with
// the selection written and a revisited leaf marked on the path. Returns
// whether it ended.
__device__ __forceinline__ bool settle(Sel& sel, const Nodes& sh, int cur, int act, int c, float tb,
                                       int lane) {
  if (c == -1 || c <= -3) {
    sel.parent = cur;
    sel.action = act;
    sel.is_new = c == -1;
    sel.leaf = sel.is_new ? -1 : -3 - c;
    sel.prior = tb;
    if (!sel.is_new && lane == 0) sh.path[sel.leaf] = 1;
    return true;
  }
  return false;
}

__device__ __forceinline__ void write_selection(const Args& p, int b, const Nodes& sh,
                                                const Sel& sel, int lane) {
  uint8_t* npath = p.npath + (size_t)b * p.cap;
  for (int n = lane; n < p.cap; n += 32) npath[n] = sh.path[n];
  if (lane == 0) {
    p.nparent[b] = sel.parent;
    p.naction[b] = sel.action;
    p.nleaf[b] = sel.leaf;
    p.nnew[b] = sel.is_new ? 1 : 0;
    p.nprior[b] = sel.prior;
  }
}

// ---- the register kernel: A <= 384 ------------------------------------------

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
  const Game g = game_of(p, b);
  const Nodes sh = nodes_of(smem, warp, cap);

  // ---- 0. every load that depends on nothing else, issued together: the
  // selection, the leaf, the root's row, then the node statistics into
  // shared memory ----------------------------------------------------------
  const bool snew = p.snew[b] != 0;
  const bool lt = p.lterm[b] != 0;
  const int sp = p.sparent[b], sa = p.saction[b], sleaf = p.sleaf[b], lturn = p.lturn[b];
  const float lvalue = p.lvalue[b], sprior = p.sprior[b];
  // the backed-up value: the leaf's, or the stored value of a revisited node
  const float v_up = (en && !snew) ? g.value[max(sleaf, 0)] : lvalue;
  float lpol[K];
  bool llive[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane + 32 * k;
    llive[k] = en && a < A && p.llegal[(size_t)b * A + a] != 0;
    lpol[k] = en && a < A ? p.lpolicy[(size_t)b * A + a] : 0.0f;
  }
  Row<K> row;  // the root's; the expansion may write one of its lanes
  load_row(row, g.cix, g.prior, A, lane);
  load_nodes(g, sh, cap, en, lane);

  // ---- 1. expand row s and write the parent's edge ------------------------
  if (en && snew) {
    float* prow = g.prior + (size_t)s * L;
    int* crow = g.cix + (size_t)s * L;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      if (a < A) {
        const bool live = llive[k] && !lt;
        prow[a] = live ? lpol[k] : 0.0f;
        crow[a] = live ? -1 : -2;
      }
    }
    const int enc = lt ? -3 - s : s;
    expand_node(p, g, sh, b, s, sp, sa, lturn, lt, enc, lvalue, sprior, lane);
    if (sp == 0 && lane == (sa & 31)) {  // the edge lies in the root's row
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == (sa >> 5)) row.c[k] = enc;
    }
  }
  __syncwarp();
  if (en && snew && s == 0) load_row(row, g.cix, g.prior, A, lane);  // the root rewritten

  // ---- 2. back up along the path plus the start node, and prefetch the
  // rows of the path into L2 ---------------------------------------------------
  if (en) backup(g, sh, cap, L, snew ? s : max(sleaf, 0), v_up, lane);
  __syncwarp();

  // ---- 3. PUCT walk from the root -----------------------------------------
  puct_factors(p, sh, cap, lane);
  __syncwarp();
  int cur = 0;
  Sel sel;
  for (int depth = 0; depth < cap; ++depth) {
    const bool flip = p.flip && row.turn == 2;
    const float bias = sh.bias[cur], sq = sh.sq[cur];
    if (lane == 0) sh.path[cur] = 1;
    Level lv;
#pragma unroll
    for (int k = 0; k < K; ++k)
      lv.take(sh, lane + 32 * k, row.c[k], [pr = row.pr[k]] { return pr; }, flip, bias, sq);
    // the best child, and its row on its way before init-Q is known
    lv.child = warp_best(lv.child);
    int child_c = -2;
    if (lv.child.act >= 0)
      child_c = __shfl_sync(kFull, pick(row.c, lv.child.act >> 5), lv.child.act & 31);
    Row<K> next;
    const int nx = child_c >= 0 ? child_c : cur;
    load_row(next, g.cix + (size_t)nx * L, g.prior + (size_t)nx * L, A, lane);
    int c = child_c;
    const Best best = lv.choose(p.init_q_average, bias, sq, c);
    int act = best.act;
    float tb = best.tb;
    if (act < 0) {  // no candidate at all: the reference's argmax gives A - 1
      act = A - 1;
      tb = -INFINITY;
      c = __shfl_sync(kFull, pick(row.c, act >> 5), act & 31);
    }
    if (settle(sel, sh, cur, act, c, tb, lane)) break;
    // a child (c >= 0), or no candidate at all (c == -2): the reference
    // then clamps to the root
    cur = max(c, 0);
    if (cur == nx) row = next;  // already on its way
    else load_row(row, g.cix + (size_t)cur * L, g.prior + (size_t)cur * L, A, lane);
  }
  __syncwarp();
  write_selection(p, b, sh, sel, lane);
}

// ---- the wide kernel: A > 384 ---------------------------------------------

constexpr size_t kMaxBlockSmem = 232448;  // Hopper's opt-in shared memory a block
constexpr int kShapeTooLarge = -1;        // the block does not fit
constexpr int kRegisterSlots = 12;        // the register kernel's largest K
constexpr int kMaxWideWarps = 8;
constexpr int kWideMinBlocks = 4;  // blocks an SM the registers must allow
constexpr int kSlotBytes = 48;     // one warp's share of a block reduction

// warps of the wide kernel's block (one game): ceil(A / 384), at least 2,
// at most 8
__host__ __device__ inline int wide_warps(int A) {
  const int w = (A + 383) / 384;
  return w < 2 ? 2 : w > kMaxWideWarps ? kMaxWideWarps : w;
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~(size_t)15; }

// bytes of the 16-byte aligned window that a bulk copy of a row of `bytes`
// fetches, wherever the row starts
__host__ __device__ inline size_t row_window(size_t bytes) { return round16(bytes + 15); }

// The wide kernel's shared memory, byte offsets from the block's base: two
// mbarriers, two sets of W reduction slots, two row buffers (cix, prior),
// then the node statistics (visits, mean, pedge, PUCT bias and sqrt(n)
// [cap] floats, parent and the next node on the previous path [cap] ints;
// path [cap] bytes).
struct WideLayout {
  size_t slots, ci[2], pr[2], nodes, path, total;
  __host__ __device__ WideLayout(int cap, int L, int W) {
    size_t o = 16;
    slots = o;
    o += (size_t)2 * W * kSlotBytes;
    for (int k = 0; k < 2; ++k) {
      ci[k] = o;
      o += row_window((size_t)4 * L);
      pr[k] = o;
      o += row_window((size_t)4 * L);
    }
    nodes = o;
    o += round16((size_t)28 * cap);
    path = o;
    o += round16(cap);
    total = o;
  }
};

// ---- Hopper bulk copies into shared memory ---------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// generic-proxy accesses of this thread before async-proxy ones (bulk copies)
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// Wait for the phase of parity `parity` of `bar` (every thread of the block
// waits every phase, in order), then flip the parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned& parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
  parity ^= 1u;
}

// The 16-byte aligned window around the row [p, p + bytes).
struct Window {
  size_t lo;
  unsigned len;
  __device__ __forceinline__ Window(const void* p, size_t bytes) {
    const size_t g = __cvta_generic_to_global(p);
    lo = g & ~(size_t)15;
    len = (unsigned)(((g + bytes + 15) & ~(size_t)15) - lo);
  }
};

// the row [p, p + ...) inside the window staged at `buf`
template <typename T>
__device__ __forceinline__ T* staged(unsigned char* buf, const void* p) {
  return reinterpret_cast<T*>(buf + (__cvta_generic_to_global(p) & 15));
}

__device__ __forceinline__ void bulk_copy(unsigned char* dst, const Window& w, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(w.lo), "r"(w.len), "r"(smem_u32(bar)) : "memory");
}

// Thread 0: stage node's cix and prior rows (L lanes each), completing one
// phase of `bar`.
__device__ __forceinline__ void stage_node(const Game& g, uint64_t* bar, unsigned char* ci,
                                           unsigned char* pr, int node, int L) {
  const size_t o = (size_t)node * L;
  const Window wc(g.cix + o, (size_t)4 * L), wp(g.prior + o, (size_t)4 * L);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(wc.len + wp.len) : "memory");
  bulk_copy(ci, wc, bar);
  bulk_copy(pr, wp, bar);
}

// ---- block-wide reductions (the warp versions above, twice) ----------------

// The block's threads and its two sets of reduction slots.
struct Team {
  int tid, T, W, warp, lane;
  unsigned char* slots;
  unsigned round;
  // the slots of the next round: a warp can reach round r + 2 only after
  // every warp has left round r + 1's barrier, so after it read round r's
  __device__ __forceinline__ unsigned char* next_slots() {
    return slots + (size_t)(round++ & 1u) * W * kSlotBytes;
  }
};

// A walk level's candidates, reduced over the block, with the best child's
// edge lane (read from the staged row before the barrier, so that no thread
// reads the row after it).
struct LevelSum {
  Best child;
  int child_c;
  float open_pr;
  int open_act;
  double sum_q;
  unsigned nv;
};

struct alignas(16) LevelSlot {
  float score, tb;
  int act, child_c;
  float open_pr;
  int open_act;
  unsigned nv, pad0;
  double sum_q;
  double pad1;
};
static_assert(sizeof(LevelSlot) == kSlotBytes, "a level's slot");

// One round: every thread gets the level's best child and its edge lane in
// the staged row `crow`, its open lane of largest prior, and the children's
// q summed (double) and counted.
__device__ __forceinline__ LevelSum block_level(Team& t, const Level& lv, const int* crow) {
  LevelSlot* s = reinterpret_cast<LevelSlot*>(t.next_slots());
  // action a lies in lane a % 32 (32 divides the block's width)
  const Best cb = warp_best(lv.child);
  const unsigned kp = lv.open_act >= 0 ? fkey(lv.open_pr) : 0u;
  const unsigned kpmax = __reduce_max_sync(kFull, kp);
  const unsigned omin = __reduce_min_sync(
      kFull, (lv.open_act >= 0 && kp == kpmax) ? (unsigned)lv.open_act : kNoAction);
  const int oa = omin == kNoAction ? -1 : (int)omin;
  const float op = __shfl_sync(kFull, lv.open_pr, omin & 31u);
  const double sq = warp_sum(lv.sum_q);
  const unsigned nv = __reduce_add_sync(kFull, (unsigned)lv.nv);
  if (t.lane == 0)
    s[t.warp] = LevelSlot{cb.score, cb.tb, cb.act, cb.act >= 0 ? crow[cb.act] : -2, op, oa, nv,
                          0u, sq, 0.0};
  __syncthreads();
  // the W shares, combined in order by every thread alike: the same order
  // as the warp reductions (better(); the largest prior key, then the
  // lowest action), the sums in a fixed order
  LevelSum r{Best{0.0f, 0.0f, -1}, -2, 0.0f, -1, 0.0, 0u};
  for (int w = 0; w < t.W; ++w) {
    const LevelSlot x = s[w];
    const Best xb{x.score, x.tb, x.act};
    if (better(xb, r.child)) {
      r.child = xb;
      r.child_c = x.child_c;
    }
    if (x.open_act >= 0) {
      const unsigned kx = fkey(x.open_pr), kr = fkey(r.open_pr);
      if (r.open_act < 0 || kx > kr || (kx == kr && x.open_act < r.open_act)) {
        r.open_pr = x.open_pr;
        r.open_act = x.open_act;
      }
    }
    r.sum_q += x.sum_q;
    r.nv += x.nv;
  }
  return r;
}

// Level::choose on the block's sums (c becomes -1 when the open lane wins)
__device__ __forceinline__ Best choose_level(const LevelSum& r, bool init_q_average, float bias,
                                             float sq, int& c) {
  const float sqf = (float)r.sum_q;
  const float nvf = (float)r.nv;
  float init_q;
  if (init_q_average) init_q = nvf > 0.0f ? sqf / fmaxf(nvf, 1.0f) : 1.0f;
  else init_q = (sqf - 1.0f) / (nvf + 1.0f);
  Best best = r.child;
  if (r.open_act >= 0) {
    const Best open{init_q + bias * r.open_pr * sq, r.open_pr, r.open_act};
    if (better(open, best)) {
      best = open;
      c = -1;
    }
  }
  return best;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (__cvta_generic_to_global(p) & 15) == 0;
}

// Row s's action lanes: the prior of a live lane (legal, leaf not
// terminal) and -1 (open) or -2, four actions a thread in flight; in 16-byte
// vectors when A % 4 == 0 and the rows are aligned.
__device__ __forceinline__ void expand_rows(const float* lpolicy, const uint8_t* llegal,
                                            float* prow, int* crow, bool lt, int A, int tid,
                                            int T) {
  const bool vec = A % 4 == 0 && aligned16(lpolicy) && aligned16(prow) && aligned16(crow) &&
                   (__cvta_generic_to_global(llegal) & 3) == 0;
  if (vec) {
    const int A4 = A / 4;
    const float4* pol4 = reinterpret_cast<const float4*>(lpolicy);
    const uint32_t* leg4 = reinterpret_cast<const uint32_t*>(llegal);
    float4* pri4 = reinterpret_cast<float4*>(prow);
    int4* cix4 = reinterpret_cast<int4*>(crow);
    for (int q0 = tid; q0 < A4; q0 += 2 * T) {
      float4 pol[2];
      uint32_t lg[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = q0 + j * T;
        pol[j] = q < A4 ? pol4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        lg[j] = q < A4 ? leg4[q] : 0u;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = q0 + j * T;
        if (q < A4) {
          const bool l0 = (lg[j] & 0xffu) && !lt, l1 = (lg[j] & 0xff00u) && !lt;
          const bool l2 = (lg[j] & 0xff0000u) && !lt, l3 = (lg[j] & 0xff000000u) && !lt;
          pri4[q] = make_float4(l0 ? pol[j].x : 0.0f, l1 ? pol[j].y : 0.0f, l2 ? pol[j].z : 0.0f,
                                l3 ? pol[j].w : 0.0f);
          cix4[q] = make_int4(l0 ? -1 : -2, l1 ? -1 : -2, l2 ? -1 : -2, l3 ? -1 : -2);
        }
      }
    }
    return;
  }
  for (int a0 = tid; a0 < A; a0 += 4 * T) {
    float pol[4];
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + j * T;
      live[j] = a < A && llegal[a] != 0 && !lt;
      pol[j] = a < A ? lpolicy[a] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + j * T;
      if (a < A) {
        prow[a] = live[j] ? pol[j] : 0.0f;
        crow[a] = live[j] ? -1 : -2;
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxWideWarps, kWideMinBlocks)
tree_step_v2_wide_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char wsm[];
  const int b = blockIdx.x;
  const int cap = p.cap, A = p.A, L = p.L, s = p.s;
  Team team{(int)threadIdx.x, (int)blockDim.x, (int)(blockDim.x >> 5), (int)(threadIdx.x >> 5),
            (int)(threadIdx.x & 31), nullptr, 0u};
  const int tid = team.tid, T = team.T;
  const WideLayout lay(cap, L, team.W);
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsm);
  team.slots = wsm + lay.slots;
  unsigned char* const ci_buf[2] = {wsm + lay.ci[0], wsm + lay.ci[1]};
  unsigned char* const pr_buf[2] = {wsm + lay.pr[0], wsm + lay.pr[1]};
  float* nf = reinterpret_cast<float*>(wsm + lay.nodes);
  int* up = reinterpret_cast<int*>(nf + 5 * cap);  // parent
  int* nxt = up + cap;                             // the next node on the previous path
  const Nodes sh{nf, nf + cap, nf + 2 * cap, nf + 3 * cap, nf + 4 * cap, wsm + lay.path};

  const bool en = p.phase > 0;
  const Game g = game_of(p, b);
  // the root's rows: staged right away, unless this step rewrites them (a
  // new leaf at row 0), then once the expansion has written them
  const bool late_root = en && s == 0 && p.snew[b] != 0;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0 && !late_root) stage_node(g, &bar[0], ci_buf[0], pr_buf[0], 0, L);

  // ---- 0. the selection, the leaf, then the node statistics into shared
  // memory -----------------------------------------------------------------
  const bool snew = p.snew[b] != 0;
  const bool lt = p.lterm[b] != 0;
  const int sp = p.sparent[b], sa = p.saction[b], sleaf = p.sleaf[b], lturn = p.lturn[b];
  const float lvalue = p.lvalue[b], sprior = p.sprior[b];
  const float v_up = (en && !snew) ? g.value[max(sleaf, 0)] : lvalue;
  const int* pvec = p.pvec + (size_t)b * cap;
  for (int n = tid; n < cap; n += T) {
    const float v = g.vis[n], m = g.mean[n], e = g.pedge[n];
    const int pv = pvec[n];
    const uint8_t on = en ? g.spath[n] : 0;
    sh.vis[n] = v;
    sh.mean[n] = m;
    sh.pedge[n] = e;
    up[n] = pv;
    nxt[n] = -1;
    sh.path[n] = on;
  }

  // ---- 1. expand row s and write the parent's edge ------------------------
  const int enc = lt ? -3 - s : s;
  if (en && snew) {
    expand_rows(p.lpolicy + (size_t)b * A, p.llegal + (size_t)b * A, g.prior + (size_t)s * L,
                g.cix + (size_t)s * L, lt, A, tid, T);
    if (team.warp == 0) expand_node(p, g, sh, b, s, sp, sa, lturn, lt, enc, lvalue, sprior, team.lane);
    if (tid == 0) up[s] = sp;
    fence_async_global();  // a bulk copy below may stage what was written here
  }
  __syncthreads();

  // ---- 2. warp 0: the next node of every node on the previous path (the
  // walk's prediction), then the backup along the path plus the start node,
  // and the rows of the path prefetched into L2; the root's rows land (the
  // expansion's edge into the root patched) -------------------------------------
  const int start = snew ? s : max(sleaf, 0);
  if (team.warp == 0) {
    if (tid == 0 && late_root) stage_node(g, &bar[0], ci_buf[0], pr_buf[0], 0, L);
    if (en) {
      for (int n = team.lane; n < cap; n += 32) {
        const int u = up[n];
        if ((sh.path[n] || n == start) && u >= 0 && u < cap) nxt[u] = n;
      }
      __syncwarp();
      backup(g, sh, cap, L, start, v_up, team.lane);
    }
    if (tid == 0 && !late_root) {
      unsigned ph = 0u;
      mbar_wait(&bar[0], ph);
      if (en && snew && sp == 0) staged<int>(ci_buf[0], g.cix)[sa] = enc;
      fence_async_shared();  // buffer 0 is staged again later in the walk
    }
  }
  __syncthreads();

  // ---- 3. PUCT walk from the root (the factors: each warp a slice) ----------
  // A level stages the next node that the previous path predicts into the
  // other buffer before its pass; when the walk goes elsewhere it waits out
  // that copy and stages the chosen node. No thread reads a level's row
  // after its round's barrier, so the next level may overwrite it.
  {
    const int run = (cap + team.W - 1) / team.W;
    const int n0 = team.warp * run;
    const int len = min(run, cap - n0);
    if (len > 0) {
      const Nodes part{sh.vis + n0, sh.mean + n0, sh.pedge + n0, sh.bias + n0, sh.sq + n0,
                       sh.path + n0};
      puct_factors(p, part, len, team.lane);
    }
  }
  unsigned par[2] = {0u, 0u};
  mbar_wait(&bar[0], par[0]);
  __syncthreads();
  int cur = 0, k = 0;
  bool pending[2] = {false, false};
  Sel sel;
  for (int depth = 0; depth < cap; ++depth) {
    if (pending[k]) {
      mbar_wait(&bar[k], par[k]);
      pending[k] = false;
    }
    const int pred = nxt[cur];
    if (pred >= 0) {
      if (tid == 0) stage_node(g, &bar[k ^ 1], ci_buf[k ^ 1], pr_buf[k ^ 1], pred, L);
      pending[k ^ 1] = true;
    }
    const size_t o = (size_t)cur * L;
    const int* crow = staged<int>(ci_buf[k], g.cix + o);
    const float* prow = staged<float>(pr_buf[k], g.prior + o);
    const bool flip = p.flip && crow[A + 2] == 2;
    const int last_c = crow[A - 1];
    const float bias = sh.bias[cur], sq = sh.sq[cur];
    if (tid == 0) sh.path[cur] = 1;
    Level lv;
    for (int a = tid; a < A; a += T)
      lv.take(sh, a, crow[a], [&] { return prow[a]; }, flip, bias, sq);
    const LevelSum r = block_level(team, lv, crow);
    int c = r.child_c;
    const Best best = choose_level(r, p.init_q_average, bias, sq, c);
    int act = best.act;
    float tb = best.tb;
    if (act < 0) {  // no candidate at all: the reference's argmax gives A - 1
      act = A - 1;
      tb = -INFINITY;
      c = last_c;
    }
    if (settle(sel, sh, cur, act, c, tb, tid)) break;
    // a child (c >= 0), or no candidate at all (c == -2): the reference
    // then clamps to the root
    const int next = max(c, 0);
    if (next != pred) {  // the walk left the previous path
      if (pending[k ^ 1]) {
        mbar_wait(&bar[k ^ 1], par[k ^ 1]);
        // every thread has seen that phase complete before the barrier
        // starts the next: a parity wait cannot tell them apart
        __syncthreads();
      }
      if (tid == 0) stage_node(g, &bar[k ^ 1], ci_buf[k ^ 1], pr_buf[k ^ 1], next, L);
      pending[k ^ 1] = true;
    }
    cur = next;
    k ^= 1;
  }
  // no bulk copy may land after the block has left
  for (int j = 0; j < 2; ++j)
    if (pending[j]) mbar_wait(&bar[j], par[j]);
  __syncthreads();
  if (team.warp == 0) write_selection(p, b, sh, sel, team.lane);
}

using KernelFn = void (*)(const Args);

// the instantiation for A actions: K = ceil(A / 32) slots, rounded up to
// one of the compiled sizes; the wide kernel above 12 slots (A > 384)
KernelFn kernel_for(int A) {
  const int k = (A + 31) / 32;
  if (k <= 1) return tree_step_v2_kernel<1>;
  if (k == 2) return tree_step_v2_kernel<2>;
  if (k == 3) return tree_step_v2_kernel<3>;
  if (k == 4) return tree_step_v2_kernel<4>;
  if (k <= 8) return tree_step_v2_kernel<8>;
  if (k <= kRegisterSlots) return tree_step_v2_kernel<kRegisterSlots>;
  return tree_step_v2_wide_kernel;
}

bool is_wide(int A) { return A > 32 * kRegisterSlots; }

// dynamic shared memory a block: the register kernel's four warps, or the
// wide kernel's one game
size_t dynamic_smem(int cap, int A) {
  if (!is_wide(A)) return (size_t)kWarpsPerBlock * warp_smem_floats(cap) * sizeof(float);
  return WideLayout(cap, A + 8, wide_warps(A)).total;
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
  const bool wide = is_wide(A);
  const size_t smem = dynamic_smem(cap, A);
  if (smem > kMaxBlockSmem) return kShapeTooLarge;
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

  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // the register kernel: four games a block; the wide kernel: one game a
  // block of wide_warps(A) warps
  const int blocks = wide ? B : (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * (wide ? wide_warps(A) : kWarpsPerBlock);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block of the
// kernel that a launch with A actions and capacity cap runs.
extern "C" int tree_step_v2_attributes(int A, int cap, int* regs, int* static_smem,
                                       int* dynamic_smem_bytes) {
  const KernelFn kernel = kernel_for(A);
  if (dynamic_smem(cap, A) > kMaxBlockSmem) return kShapeTooLarge;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem_bytes = (int)dynamic_smem(cap, A);
  return 0;
}
