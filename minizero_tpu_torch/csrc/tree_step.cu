// Fused per-simulation MCTS tree step for a batch of search trees (Hopper,
// sm_90a). Replaces the Pallas TPU kernel
// minizero_tpu/ops/tree_kernel.py::_tree_step_kernel (wrapper
// fused_tree_step) for think_batch == 1, in both of its regimes:
//
//   - the board regime (AlphaZero, board-game MuZero): no in-tree rewards,
//     discount 1;
//   - the MuZero reward regime (Atari; reward_regime, set by the wrapper
//     for leaf rewards or a discount other than 1): the leaf's predicted
//     reward is stored at the node, the backup discounts and
//     q = reward + discount * mean.
//   In either regime value_rescale min-max normalises q to the tree's bounds.
//
// Its contract is minizero_tpu_torch/ops/tree_kernel.py::tree_step_reference:
//
//   1. expand the new leaf at slot s (node scalars, its reward, the
//      prior/logit/legal rows, the parent's child edge);
//   2. back up the leaf value: in the board regime every node of the
//      previous selection's path takes the same value (one incremental-mean
//      update per path node, lanes in parallel); otherwise one lane walks
//      the parent pointers from the leaf to the root with
//      u = reward[node] + discount * u between nodes (mcts.cpp:166-179);
//   3. root child statistics (visits, normalised and player-flipped q);
//   4. Gumbel sequential-halving tick: when every active candidate reached
//      its budget, keep the top half by logit + sigma * q (pairwise rank,
//      ties to the lower index) and extend the budget;
//   5. select the next leaf: the Gumbel root step (fewest visits among the
//      active actions, ties to the larger logit, then the lower index), then
//      a PUCT descent whose ties go to the larger prior, then the lower index;
//   6. write the next selection (parent, action, leaf, is_new, path mask).
//   phase == 0 runs steps 3 and 5-6 only.
//
// What bounds it. The least work is data-dependent: the rows that the walk
// reads (children_index, prior, legal: 9 bytes per action) for each node on
// each game's path, the root row, the leaf inputs, the new row it writes and
// the [N] node statistics the step looks at: at Go 9x9 (N = 17, A = 82,
// B = 1024) about 2.5 MB, under a microsecond at 3.35 TB/s, and the Atari
// search (N = 51, A = 18, B = 256) about 0.34 MB. The arithmetic is a few
// thousand operations per game. So the bound is bytes, and the real limit is
// latency: each walk level is a chain (row load -> children's statistics ->
// reductions -> next row), and the Atari search has only 256 warps, two per
// SM, to hide one another's. There is no matrix product, so the tensor cores
// (wgmma) and TMA tile rings have nothing to do here; the design shortens
// the dependent chain instead.
//
// Design. One warp per game, four games per 128-thread block; action a of a
// row lives in lane a % 32, slot a / 32 (K = ceil(A / 32) slots, a template
// argument, so a row sits in registers).
//   - Every load that depends on nothing else (the selection, the leaf's
//     inputs, the Gumbel state, the root's rows, the node vectors and the
//     previous path) is issued at the start, together; the expansion's edge
//     into the root is patched into the root's row in registers.
//   - Shared memory holds the game's [N] node vectors (visits, mean and, in
//     the reward regime, reward and parent; expanded, the player flag and
//     the path masks as bytes). The backups update the shared copies and
//     write back the nodes they touch. In the reward regime one lane chases
//     the parent pointers through shared memory computing only the value
//     each node receives (u = reward + discount * u, serially, as the plain
//     version does); then the lanes update their nodes in parallel. The
//     value bounds and every child's statistics are read from shared memory.
//   - Right after the backup, the rows (children_index, prior, legal) of
//     every node on the previous selection's path are prefetched into L2
//     with Hopper's bulk prefetch (cp.async.bulk.prefetch.L2, 16-byte
//     aligned), spread over the lanes.
//   - A descent level issues its three rows together and makes one pass
//     over the actions: each lane keeps its best visited legal child and its
//     unvisited legal lane of largest prior. All unvisited lanes score
//     (bias * prior) * root_sim / 1 + init_q, non-decreasing in the prior, so
//     the one of largest prior (then lowest index) is their best under the
//     argmax's order; it is compared with the best visited child once init-Q
//     is reduced. The best visited child's rows are loaded before that
//     reduction: when the descent goes on, it goes into that child unless an
//     unvisited lane wins.
//   - Argmaxes are __reduce_max_sync / __reduce_min_sync on an
//     order-preserving 32-bit key of the float (which maps -0.0 and +0.0 to
//     one value, as the reference's float comparisons do): the largest
//     score, then the largest tie-break among the lanes at it, then the
//     lowest index; counts use __reduce_add_sync.
//   - The Gumbel halving tick keeps its pairwise rank (O(A^2 / 32) per lane,
//     over a row staged in shared memory): it runs on a few simulations of
//     a move.
//
// Above 384 actions (12 slots; clobber 400, amazons 3040) a row no longer
// fits a lane's registers, and kernel_for hands out the wide kernel
// (tree_step_wide_kernel). Its contract and order of operations are the
// register kernel's, and both call the same helpers for every stage that
// does not touch a row (expansion of the node, backup, value bounds, the
// halving score, a descent level's candidates and choice, the selection);
// what differs is where a row lives:
//   - the root's row of the Gumbel step (child indices, logits, the legal and
//     active flags) is staged once in the warp's shared memory, beside a
//     scratch row of halving scores, and every pass over it strides the
//     lanes over a = lane + 32 k, as the register slots do;
//   - a descent level reads its node's rows (children_index, prior, legal)
//     straight from device memory in one strided pass, and the best visited
//     child's rows are prefetched into L2 before the init-Q reduction,
//     where the register kernel loads them into registers;
//   - the halving rank is computed for the active actions only (the others
//     are never kept), still over the whole staged row;
//   - shared memory grows with A (5 N + 3 A + (3 N + A) / 4 floats a warp),
//     so a block takes as many warps as fit the opt-in 227 KB, at most four;
//     the launcher refuses a shape where not even one warp fits (at N = 17
//     about A = 17,800) with kShapeTooLarge, which the wrapper raises as a
//     ValueError.
//
// Numerics. Built with --fmad=false and IEEE logf/sqrtf/division so that each
// multiply and add rounds like the plain PyTorch version's separate
// operations; the sum of the children's q at a node is accumulated in double
// and rounded once (as the plain version does), so it does not depend on the
// order of summation. The rescale keeps the plain version's order
// ((q - lo) / max(hi - lo, 1e-8), then 2 * s - 1, then the clamp), and the
// backup's walk is serial, as the plain version's is. Integer outputs then
// match the plain version exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;
constexpr float kNegInf = -3.4e38f;  // the JAX package's NEG_INF

struct Args {
  int B, N, A, s, phase;
  // search spec
  int use_gumbel, flip, init_q_average, num_sims;
  int use_rewards, reward_regime, value_rescale;  // reward_regime: see the top
  float puct_base, puct_init, log2_m0, sigma_visit_c, sigma_scale_c, discount;
  // tree, updated in place
  float *visits, *mean, *value, *reward;  // [B, N]
  uint8_t *expanded, *terminal;  // [B, N]
  int *parent, *afp, *to_play;   // [B, N]
  int *ci;                       // [B, N, A]
  float *prior, *logit;          // [B, N, A]
  uint8_t *legal;                // [B, N, A]
  uint8_t *gactive;              // [B, A]
  int *gm;                       // [B]
  float *gbudget;                // [B]
  int *num_nodes;                // [B]
  // this simulation's selection and its evaluated leaf
  const int *sparent, *saction, *sleaf;  // [B]
  const uint8_t *snew;                   // [B]
  const uint8_t *spath;                  // [B, N]
  const float *lpolicy, *llogit;         // [B, A]
  const uint8_t *llegal;                 // [B, A]
  const uint8_t *lterm;                  // [B]
  const float *lvalue;                   // [B]
  const int *lturn;                      // [B]
  const float *lreward;                  // [B], read only with use_rewards
  // next selection
  int *nparent, *naction, *nleaf;  // [B]
  uint8_t *nnew;                   // [B]
  uint8_t *npath;                  // [B, N]
};

// shared memory of one warp, in floats: visits, mean, reward and the
// backed-up value [N] floats, parent [N] ints, a scratch row [A] floats,
// then expanded, player-2 flag and path [N] bytes each
__host__ __device__ inline int warp_smem_floats(int N, int A) {
  return 5 * N + A + (3 * N + 3) / 4;
}

// Order-preserving key: x < y <=> key(x) < key(y) for non-NaN floats, and
// key(-0.0) == key(+0.0). Every real key is above 0, which marks "none".
__device__ __forceinline__ unsigned fkey(float x) {
  const unsigned u = __float_as_uint(x);
  return x < 0.0f ? ~u : (u & 0x7fffffffu) | 0x80000000u;
}

__device__ __forceinline__ float fkey_inv(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// argmax over a < A of score with ties to the larger tiebreak, then the
// lower index (the JAX kernel's _argmax_tiebreak: max, then max tiebreak
// among the maxima, then the lowest index whose tiebreak reaches it); the
// lane holds actions lane + 32 k.
template <int K>
__device__ __forceinline__ int argmax_tiebreak(const float (&score)[K], const float (&tb)[K],
                                               int A, int lane) {
  unsigned ks[K];
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ks[k] = lane + 32 * k < A ? fkey(score[k]) : 0u;
    m = max(m, ks[k]);
  }
  const unsigned best = __reduce_max_sync(kFull, m);
  unsigned kt[K];
  unsigned t = 0;
  const unsigned neg = fkey(kNegInf);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    kt[k] = lane + 32 * k < A ? (ks[k] == best ? fkey(tb[k]) : neg) : 0u;
    t = max(t, kt[k]);
  }
  const unsigned best_tb = __reduce_max_sync(kFull, t);
  unsigned idx = kNone;
#pragma unroll
  for (int k = K - 1; k >= 0; --k)
    if (lane + 32 * k < A && kt[k] == best_tb) idx = lane + 32 * k;
  const unsigned out = __reduce_min_sync(kFull, idx);
  return out == kNone ? A : (int)out;
}

// lowest index of the maximum of v over a < A
template <int K>
__device__ __forceinline__ int first_argmax(const float (&v)[K], int A, int lane) {
  unsigned kv[K];
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    kv[k] = lane + 32 * k < A ? fkey(v[k]) : 0u;
    m = max(m, kv[k]);
  }
  const unsigned best = __reduce_max_sync(kFull, m);
  unsigned idx = kNone;
#pragma unroll
  for (int k = K - 1; k >= 0; --k)
    if (lane + 32 * k < A && kv[k] == best) idx = lane + 32 * k;
  const unsigned out = __reduce_min_sync(kFull, idx);
  return out == kNone ? A : (int)out;
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

// element a of a register row, from the lane that holds it
template <int K, typename T>
__device__ __forceinline__ T lane_value(const T (&row)[K], int a) {
  return __shfl_sync(kFull, pick(row, a >> 5), a & 31);
}

// Bulk-prefetch [p, p + bytes) into L2, widened to 16-byte alignment.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  const size_t g = __cvta_generic_to_global(p);
  const size_t lo = g & ~(size_t)15;
  const size_t hi = (g + (size_t)bytes + 15) & ~(size_t)15;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(lo), "r"((unsigned)(hi - lo)) : "memory");
}

// The candidate order of the descent's PUCT argmax: a larger score wins,
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
  const unsigned ka = (v.act >= 0 && ks == kmax && kt == tmax) ? (unsigned)v.act : kNone;
  const unsigned amin = __reduce_min_sync(kFull, ka);
  if (amin == kNone) return Best{0.0f, 0.0f, -1};
  const int src = (int)(amin & 31u);
  return Best{__shfl_sync(kFull, v.score, src), __shfl_sync(kFull, v.tb, src), (int)amin};
}

// One node's PUCT rows in registers: the lane's actions a = lane + 32 k.
template <int K>
struct Row {
  int c[K];
  float pr[K];
  bool lg[K];
};

template <int K>
__device__ __forceinline__ void load_row(Row<K>& r, const int* ci, const float* prior,
                                         const uint8_t* legal, int A, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane + 32 * k;
    r.c[k] = a < A ? ci[a] : -1;
    r.pr[k] = a < A ? prior[a] : 0.0f;
    r.lg[k] = a < A && legal[a] != 0;
  }
}

// ---- the stages that do not touch a row, shared by both kernels ----------

// One game's slices of the trees in device memory.
struct Game {
  float *vis, *mean, *value, *reward;  // [N]
  uint8_t *expanded, *terminal;        // [N]
  int *parent, *afp, *to_play;         // [N]
  int* ci;                             // [N, A]
  float *prior, *logit;                // [N, A]
  uint8_t* legal;                      // [N, A]
  uint8_t* gactive;                    // [A]
  const uint8_t* spath;                // [N]
};

__device__ __forceinline__ Game game_of(const Args& p, int b) {
  const size_t N = p.N, A = p.A;
  return Game{p.visits + b * N, p.mean + b * N, p.value + b * N, p.reward + b * N,
              p.expanded + b * N, p.terminal + b * N,
              p.parent + b * N, p.afp + b * N, p.to_play + b * N,
              p.ci + b * N * A, p.prior + b * N * A, p.logit + b * N * A, p.legal + b * N * A,
              p.gactive + b * A, p.spath + b * N};
}

// A game's node vectors in its warp's shared memory: visits, mean, reward,
// the backed-up value u and parent [N]; expanded, player-2 flag and path
// [N] bytes. Each kernel lays them out (warp_smem_floats,
// wide_warp_smem_floats).
struct Nodes {
  float *vis, *mean, *reward, *u;
  int* parent;
  uint8_t *exp, *p2, *path;
};

// The node vectors (and the previous path, until the backup has read it)
// into shared memory, four loads a lane issued together.
__device__ __forceinline__ void load_nodes(const Game& g, const Nodes& sh, int N, bool en,
                                           bool rr, int lane) {
  for (int n0 = 0; n0 < N; n0 += 4 * 32) {
    float v[4], m[4], r[4];
    int par[4], tp[4];
    uint8_t e[4], on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      const bool in = n < N;
      v[j] = in ? g.vis[n] : 0.0f;
      m[j] = in ? g.mean[n] : 0.0f;
      e[j] = in ? g.expanded[n] : 0;
      tp[j] = in ? g.to_play[n] : 0;
      r[j] = in && rr ? g.reward[n] : 0.0f;
      par[j] = in && rr ? g.parent[n] : -1;
      on[j] = in && en ? g.spath[n] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      if (n < N) {
        sh.vis[n] = v[j];
        sh.mean[n] = m[j];
        sh.reward[n] = r[j];
        sh.parent[n] = par[j];
        sh.exp[n] = e[j];
        sh.p2[n] = tp[j] == 2;
        sh.path[n] = on[j];
      }
    }
  }
}

// The new leaf's node scalars at slot s and the parent's edge into it (one
// lane's share of the expansion; the rows are the kernels' own).
__device__ __forceinline__ void expand_node(const Args& p, const Game& g, const Nodes& sh, int b,
                                            int s, int sp, int sa, bool edge, bool lt, int lturn,
                                            float lvalue, float lreward, int num_nodes) {
  g.expanded[s] = lt ? 0 : 1;
  g.terminal[s] = lt ? 1 : 0;
  g.parent[s] = sp;
  g.afp[s] = sa;
  g.to_play[s] = lturn;
  g.value[s] = lvalue;
  sh.exp[s] = lt ? 0 : 1;
  sh.p2[s] = lturn == 2;
  sh.parent[s] = sp;
  if (p.use_rewards) {
    g.reward[s] = lreward;
    sh.reward[s] = lreward;
  }
  p.num_nodes[b] = max(num_nodes, s + 1);
  if (edge) g.ci[(size_t)sp * p.A + sa] = s;
}

// Step 2: back up v_up and prefetch the rows of the previous path into L2.
// In the board regime every path node (and the leaf) receives the same
// value; in the reward regime one lane walks the parent pointers from the
// leaf to the root (this step's expansion included) computing the value
// each node receives, u = reward[node] + discount * u, serially as the
// plain version does, and marks the node (a path has at most N nodes); then
// every lane updates its marked nodes.
__device__ __forceinline__ void backup(const Args& p, const Game& g, const Nodes& sh, int N,
                                       int A, int leaf, float v_up, bool rr, int lane) {
  for (int n = lane; n < N; n += 32) {
    const bool on_path = sh.path[n] != 0;
    sh.path[n] = 0;
    if (on_path) {
      prefetch_l2(g.ci + (size_t)n * A, A * 4);
      prefetch_l2(g.prior + (size_t)n * A, A * 4);
      prefetch_l2(g.legal + (size_t)n * A, A);
    }
    if (!rr && (on_path || n == leaf)) {
      const float c = sh.vis[n] + 1.0f;
      const float m = sh.mean[n] + (v_up - sh.mean[n]) / fmaxf(c, 1.0f);
      sh.vis[n] = c;
      sh.mean[n] = m;
      g.vis[n] = c;
      g.mean[n] = m;
    }
  }
  if (rr) {
    __syncwarp();
    if (lane == 0) {
      float u = v_up;
      int cur = leaf;
      for (int it = 0; it < N && cur >= 0; ++it) {
        sh.u[cur] = u;
        sh.path[cur] = 1;
        u = sh.reward[cur] + p.discount * u;
        cur = sh.parent[cur];
      }
    }
    __syncwarp();
    for (int n = lane; n < N; n += 32) {
      if (sh.path[n]) {
        sh.path[n] = 0;
        const float c = sh.vis[n] + 1.0f;
        const float m = sh.mean[n] + (sh.u[n] - sh.mean[n]) / fmaxf(c, 1.0f);
        sh.vis[n] = c;
        sh.mean[n] = m;
        g.vis[n] = c;
        g.mean[n] = m;
      }
    }
  }
}

// Per-node raw q and, with value_rescale, the tree's value bounds over the
// visited nodes (mcts.cpp:40-53, 219-228), fixed for the rest of the step.
struct QNorm {
  const float *vis, *mean, *reward;  // the shared node vectors
  float discount, lo, hi;
  bool rr, rescale, enough;

  __device__ __forceinline__ float node(int n) const {
    return rr ? reward[n] + discount * mean[n] : mean[n];
  }
  // value rescale (1 while fewer than 2 nodes are visited), then the player
  // flip (mcts._normalize_q)
  __device__ __forceinline__ float norm(float q, bool flip) const {
    if (rescale) {
      if (enough) {
        float sc = (q - lo) / fmaxf(hi - lo, 1e-8f);
        sc = 2.0f * sc - 1.0f;
        q = fminf(fmaxf(sc, -1.0f), 1.0f);
      } else {
        q = 1.0f;
      }
    }
    return flip ? -q : q;
  }
};

__device__ __forceinline__ QNorm value_bounds(const Args& p, const Nodes& sh, int N, bool rr,
                                              int lane) {
  QNorm qn{sh.vis, sh.mean, sh.reward, p.discount, 0.0f, 0.0f, rr, p.value_rescale != 0, false};
  if (qn.rescale) {
    unsigned lo = fkey(3.4e38f), hi = fkey(kNegInf);
    unsigned visited = 0;
    for (int n = lane; n < N; n += 32) {
      if (sh.vis[n] > 0.0f) {
        const unsigned q = fkey(qn.node(n));
        lo = min(lo, q);
        hi = max(hi, q);
        visited += 1;
      }
    }
    qn.lo = fkey_inv(__reduce_min_sync(kFull, lo));
    qn.hi = fkey_inv(__reduce_max_sync(kFull, hi));
    qn.enough = __reduce_add_sync(kFull, visited) >= 2;
  }
  return qn;
}

// A root action's halving score: logit + sigma * q of its child (0 for an
// unvisited one); NEG_INF unless legal and visited, and unless active.
__device__ __forceinline__ float halving_score(const QNorm& qn, float logit, bool legal,
                                               bool active, int c, float cv, float sigma,
                                               bool flip_root) {
  const float q_vis = (c >= 0 && cv > 0.0f) ? qn.norm(qn.node(c), flip_root) : 0.0f;
  float score = logit + sigma * q_vis;
  if (!(legal && cv > 0.0f)) score = kNegInf;
  return active ? score : kNegInf;
}

// The budget that the halving tick adds (gumbel.py's sequential halving).
__device__ __forceinline__ float next_budget(const Args& p, int gm) {
  return floorf((float)p.num_sims / (p.log2_m0 * fmaxf((float)gm / 2.0f, 1.0f)));
}

// One PUCT descent level. take() sees the node's actions one at a time,
// each lane its own: the lane's best visited legal child, its unvisited
// legal action of largest prior, and its share of the visited children's
// q. An unvisited action scores (bias * prior) * root_sim / 1 + init_q: the
// same init_q for all of them, non-decreasing in the prior (bias >= 0,
// root_sim >= 0, rounding is monotone), so the one of largest prior (then
// lowest action) is the best of them under the argmax's order.
struct Level {
  Best vis_best{0.0f, 0.0f, -1};
  float open_p = 0.0f;
  int open_a = -1;
  double sum_q = 0.0;
  unsigned num_visited = 0;

  __device__ __forceinline__ void take(const QNorm& qn, int a, int c, float pr, bool lg,
                                       bool flip, float bias, float root_sim) {
    const float cv = c >= 0 ? qn.vis[c] : 0.0f;
    if (c >= 0 && cv > 0.0f) {
      const float q = qn.norm(qn.node(c), flip);
      sum_q += (double)q;
      num_visited += 1;
      if (lg) {
        const float u = bias * pr * root_sim / (1.0f + cv);
        const Best cand{u + q, pr, a};
        if (better(cand, vis_best)) vis_best = cand;
      }
    } else if (lg && (open_a < 0 || pr > open_p)) {
      open_p = pr;
      open_a = a;
    }
  }

  // The level's best action (act < 0: no legal one), once vis_best holds
  // the warp's best visited child: that child, or the unvisited action of
  // largest prior if it scores higher with init-Q.
  __device__ __forceinline__ Best choose(bool init_q_average, float bias, float root_sim) const {
    const unsigned kp = open_a >= 0 ? fkey(open_p) : 0u;
    const unsigned kpmax = __reduce_max_sync(kFull, kp);
    const unsigned open_min = __reduce_min_sync(
        kFull, (open_a >= 0 && kp == kpmax) ? (unsigned)open_a : kNone);
    const float sq = (float)warp_sum(sum_q);
    const float nv = (float)__reduce_add_sync(kFull, num_visited);
    float init_q;
    if (init_q_average) init_q = nv > 0.0f ? sq / fmaxf(nv, 1.0f) : 1.0f;
    else init_q = (sq - 1.0f) / (nv + 1.0f);
    Best best = vis_best;
    if (open_min != kNone) {
      const int oa = (int)open_min;
      const float opr = __shfl_sync(kFull, open_p, oa & 31);
      const float u = bias * opr * root_sim / (1.0f + 0.0f);  // no visits
      const Best open{u + init_q, opr, oa};
      if (better(open, best)) best = open;
    }
    return best;
  }
};

// The next selection.
struct Sel {
  int parent = 0, action = 0, leaf = -1;
  bool is_new = false;
};

// The walk took action `act` at `node`, whose child there is `child`: a new
// edge or an unexpanded child ends it, with the selection written and the
// leaf marked on the path. Returns whether it ended.
__device__ __forceinline__ bool settle(Sel& sel, const Nodes& sh, int node, int act, int child,
                                       int lane) {
  if (child < 0) {
    sel.parent = node; sel.action = act; sel.leaf = -1; sel.is_new = true;
    return true;
  }
  if (!sh.exp[child]) {
    sel.parent = node; sel.action = act; sel.leaf = child; sel.is_new = false;
    if (lane == 0) sh.path[child] = 1;
    return true;
  }
  return false;
}

__device__ __forceinline__ void write_selection(const Args& p, int b, const Nodes& sh,
                                                const Sel& sel, int lane) {
  uint8_t* npath = p.npath + (size_t)b * p.N;
  for (int n = lane; n < p.N; n += 32) npath[n] = sh.path[n];
  if (lane == 0) {
    p.nparent[b] = sel.parent;
    p.naction[b] = sel.action;
    p.nleaf[b] = sel.leaf;
    p.nnew[b] = sel.is_new ? 1 : 0;
  }
}

// ---- the register kernel: A <= 384 ------------------------------------------

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tree_step_kernel(const Args p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= p.B) return;  // whole warp: b is uniform across its lanes

  const int N = p.N, A = p.A, s = p.s;
  const bool en = p.phase > 0;
  const bool rr = p.reward_regime != 0;
  const Game g = game_of(p, b);

  float* base = smem + (size_t)warp * warp_smem_floats(N, A);
  float* s_row = base + 5 * N;  // the halving scores
  uint8_t* bytes = reinterpret_cast<uint8_t*>(s_row + A);
  const Nodes sh{base, base + N, base + 2 * N, base + 3 * N,
                 reinterpret_cast<int*>(base + 4 * N), bytes, bytes + N, bytes + 2 * N};

  // ---- 0. every load that depends on nothing else, issued together: the
  // selection, the leaf, the Gumbel state and the root's rows, then the
  // node vectors (and the previous path) into shared memory ---------------
  const bool snew = p.snew[b] != 0;
  const bool lt = p.lterm[b] != 0;
  const int sp = p.sparent[b], sa = p.saction[b], lturn = p.lturn[b];
  const int leaf = snew ? s : p.sleaf[b];
  const float lvalue = p.lvalue[b];
  const float lreward = p.use_rewards ? p.lreward[b] : 0.0f;
  const int num_nodes = p.num_nodes[b];
  // the backed-up value: the leaf's, or the stored value of a revisited node
  const float v_up = snew ? lvalue : (en && leaf >= 0) ? g.value[leaf] : 0.0f;
  float lpol[K], llog[K];
  bool llg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane + 32 * k;
    llg[k] = en && a < A && p.llegal[(size_t)b * A + a] != 0;
    lpol[k] = en && a < A ? p.lpolicy[(size_t)b * A + a] : 0.0f;
    llog[k] = en && a < A ? p.llogit[(size_t)b * A + a] : 0.0f;
  }
  int gm = 0;
  float gbudget = 0.0f;
  int r_ci[K];
  float r_logit[K];
  bool r_legal[K], r_active[K];
  if (p.use_gumbel) {
    gm = p.gm[b];
    gbudget = p.gbudget[b];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      r_ci[k] = a < A ? g.ci[a] : -1;
      r_logit[k] = a < A ? g.logit[a] : 0.0f;
      r_legal[k] = a < A && g.legal[a] != 0;
      r_active[k] = a < A && g.gactive[a] != 0;
    }
  }
  load_nodes(g, sh, N, en, rr, lane);

  // ---- 1. expand the new leaf at slot s ----------------------------------
  if (en && snew) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      if (a < A) {
        const bool lg = llg[k] && !lt;
        g.prior[(size_t)s * A + a] = lg ? lpol[k] : 0.0f;
        g.logit[(size_t)s * A + a] = lg ? llog[k] : 0.0f;
        g.legal[(size_t)s * A + a] = lg ? 1 : 0;
      }
    }
    const bool edge = sp >= 0 && sp < N && sa >= 0 && sa < A;
    if (lane == 0) expand_node(p, g, sh, b, s, sp, sa, edge, lt, lturn, lvalue, lreward, num_nodes);
    if (p.use_gumbel && edge && sp == 0 && lane == (sa & 31)) {  // in the root's row
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == (sa >> 5)) r_ci[k] = s;
    }
  }
  __syncwarp();
  if (p.use_gumbel && en && snew && s == 0) {  // the root rewritten
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      r_ci[k] = a < A ? g.ci[a] : -1;
      r_logit[k] = a < A ? g.logit[a] : 0.0f;
      r_legal[k] = a < A && g.legal[a] != 0;
    }
  }

  // ---- 2. back up, and prefetch the rows of the path into L2 ---------------
  if (en) backup(p, g, sh, N, A, leaf, v_up, rr, lane);
  __syncwarp();
  const QNorm qn = value_bounds(p, sh, N, rr, lane);

  // ---- 3-5a. root statistics, halving tick, Gumbel root step -------------
  int first_action = -1;
  if (p.use_gumbel) {
    const bool flip_root = p.flip && sh.p2[0];
    float cv[K], sig[K];
    unsigned max_count = 0;
    bool reached = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = r_ci[k];
      cv[k] = c >= 0 ? sh.vis[c] : 0.0f;
      if (lane + 32 * k < A) {
        max_count = max(max_count, fkey(cv[k]));
        if (r_active[k] && !(cv[k] >= gbudget)) reached = false;
      }
    }
    const float max_c = fkey_inv(__reduce_max_sync(kFull, max_count));
    const bool all_reached = __all_sync(kFull, reached);
    const float sigma = (p.sigma_visit_c + max_c) * p.sigma_scale_c;
#pragma unroll
    for (int k = 0; k < K; ++k)
      sig[k] = halving_score(qn, r_logit[k], r_legal[k], r_active[k], r_ci[k], cv[k], sigma,
                             flip_root);
    const float budget = next_budget(p, gm);
    const bool do_halve = all_reached && budget > 0.0f && gm > 2 && en;
    if (do_halve) {  // uniform across the warp
      const int new_m = gm / 2;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k < A) s_row[lane + 32 * k] = sig[k];
      __syncwarp();
      float kept[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = lane + 32 * k;
        const float ma = sig[k];
        int rank = 0;
        if (a < A) {
          for (int j = 0; j < A; ++j) {
            const float mj = s_row[j];
            rank += (mj > ma) || (mj == ma && j < a);
          }
        }
        const bool keep = r_active[k] && rank < new_m;
        kept[k] = keep ? ma : kNegInf;
        r_active[k] = keep;
        if (a < A) g.gactive[a] = keep ? 1 : 0;
      }
      const int best = first_argmax(kept, A, lane);
      const float best_visits = lane_value(cv, best);
      if (lane == 0) {
        p.gm[b] = new_m;
        p.gbudget[b] = best_visits + budget;
      }
    }
    // root step: fewest visits among the active actions, ties -> logit
    float count_key[K];
#pragma unroll
    for (int k = 0; k < K; ++k) count_key[k] = r_active[k] ? -cv[k] : kNegInf;
    first_action = argmax_tiebreak(count_key, r_logit, A, lane);
  }

  // ---- 5b. PUCT descent ---------------------------------------------------
  Sel sel;
  bool done = false;
  int node = 0;
  if (first_action >= 0) {
    const int child = lane_value(r_ci, first_action);
    sel.action = first_action;
    if (lane == 0) sh.path[0] = 1;
    done = settle(sel, sh, 0, first_action, child, lane);
    if (!done) node = child;
  }
  Row<K> row;
  if (!done)
    load_row(row, g.ci + (size_t)node * A, g.prior + (size_t)node * A,
             g.legal + (size_t)node * A, A, lane);
  for (int it = 0; it < N && !done; ++it) {  // `done` is uniform
    const bool flip_node = p.flip && sh.p2[node];
    const float total_sim = sh.vis[node] - 1.0f;
    const float bias = p.puct_init + logf((1.0f + total_sim + p.puct_base) / p.puct_base);
    const float root_sim = sqrtf(fmaxf(total_sim, 0.0f));
    if (lane == 0) sh.path[node] = 1;
    Level lv;
#pragma unroll
    for (int k = 0; k < K; ++k)
      lv.take(qn, lane + 32 * k, row.c[k], row.pr[k], row.lg[k], flip_node, bias, root_sim);
    // the best visited child, and its rows on their way before init-Q is
    // known: when the descent goes on, it goes into that child unless an
    // unvisited (unexpanded) lane wins
    lv.vis_best = warp_best(lv.vis_best);
    const int spec_c = lv.vis_best.act >= 0 ? lane_value(row.c, lv.vis_best.act) : -1;
    Row<K> next;
    const int nx = spec_c >= 0 ? spec_c : node;
    load_row(next, g.ci + (size_t)nx * A, g.prior + (size_t)nx * A, g.legal + (size_t)nx * A, A,
             lane);
    int act = lv.choose(p.init_q_average, bias, root_sim).act;
    if (act < 0) {  // no legal action: every score is NEG_INF
      float none[K];
#pragma unroll
      for (int k = 0; k < K; ++k) none[k] = kNegInf;
      act = argmax_tiebreak(none, row.pr, A, lane);
    }
    const int child = lane_value(row.c, act);
    done = settle(sel, sh, node, act, child, lane);
    if (!done) {
      if (child == spec_c) row = next;
      else
        load_row(row, g.ci + (size_t)child * A, g.prior + (size_t)child * A,
                 g.legal + (size_t)child * A, A, lane);
      node = child;
    }
  }
  __syncwarp();
  write_selection(p, b, sh, sel, lane);
}

// ---- the wide kernel: A > 384 ---------------------------------------------

constexpr int kRegisterSlots = 12;           // the register kernel's largest K
constexpr size_t kMaxBlockSmem = 232448;     // Hopper's opt-in shared memory a block
constexpr int kShapeTooLarge = -1;           // not one warp fits a block

// shared memory of one warp of the wide kernel, in floats: the register
// kernel's node vectors and scratch row, the root's child indices and logits
// [A] each, then expanded, player-2 flag, path [N] bytes and the root's
// flags (bit 0 legal, bit 1 active) [A] bytes
__host__ __device__ inline int wide_warp_smem_floats(int N, int A) {
  return 5 * N + 3 * A + (3 * N + A + 3) / 4;
}

// argmax_tiebreak over a row read through score(a) and tb(a), each lane
// striding over a = lane + 32 k: the register version's order (largest
// score, then the largest tie-break among the maxima, then the lowest index)
template <class S, class T>
__device__ __forceinline__ int argmax_tiebreak_wide(S score, T tb, int A, int lane) {
  unsigned m = 0;
  for (int a = lane; a < A; a += 32) m = max(m, fkey(score(a)));
  const unsigned best = __reduce_max_sync(kFull, m);
  const unsigned neg = fkey(kNegInf);
  unsigned t = 0, idx = kNone;
  for (int a = lane; a < A; a += 32) {
    const unsigned kt = fkey(score(a)) == best ? fkey(tb(a)) : neg;
    if (kt > t) {  // the lane's first a at its largest key
      t = kt;
      idx = (unsigned)a;
    }
  }
  const unsigned best_tb = __reduce_max_sync(kFull, t);
  const unsigned out = __reduce_min_sync(kFull, t == best_tb ? idx : kNone);
  return out == kNone ? A : (int)out;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tree_step_wide_kernel(const Args p) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= p.B) return;  // whole warp: b is uniform across its lanes

  const int N = p.N, A = p.A, s = p.s;
  const bool en = p.phase > 0;
  const bool rr = p.reward_regime != 0;
  const Game g = game_of(p, b);
  const float* lpolicy = p.lpolicy + (size_t)b * A;
  const float* llogit = p.llogit + (size_t)b * A;
  const uint8_t* llegal = p.llegal + (size_t)b * A;

  float* base = smem + (size_t)warp * wide_warp_smem_floats(N, A);
  float* s_row = base + 5 * N;  // the halving scores
  int* s_rci = reinterpret_cast<int*>(s_row + A);
  float* s_rlogit = reinterpret_cast<float*>(s_rci + A);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(s_rlogit + A);
  const Nodes sh{base, base + N, base + 2 * N, base + 3 * N,
                 reinterpret_cast<int*>(base + 4 * N), bytes, bytes + N, bytes + 2 * N};
  uint8_t* s_rflag = bytes + 3 * N;

  // ---- 0. the selection, the leaf, the Gumbel state and the root's row,
  // then the node vectors (and the previous path) into shared memory ------
  const bool snew = p.snew[b] != 0;
  const bool lt = p.lterm[b] != 0;
  const int sp = p.sparent[b], sa = p.saction[b], lturn = p.lturn[b];
  const int leaf = snew ? s : p.sleaf[b];
  const float lvalue = p.lvalue[b];
  const float lreward = p.use_rewards ? p.lreward[b] : 0.0f;
  const int num_nodes = p.num_nodes[b];
  const float v_up = snew ? lvalue : (en && leaf >= 0) ? g.value[leaf] : 0.0f;
  int gm = 0;
  float gbudget = 0.0f;
  if (p.use_gumbel) {
    gm = p.gm[b];
    gbudget = p.gbudget[b];
    for (int a = lane; a < A; a += 32) {
      s_rci[a] = g.ci[a];
      s_rlogit[a] = g.logit[a];
      s_rflag[a] = (g.legal[a] != 0 ? 1 : 0) | (g.gactive[a] != 0 ? 2 : 0);
    }
  }
  load_nodes(g, sh, N, en, rr, lane);
  __syncwarp();

  // ---- 1. expand the new leaf at slot s ----------------------------------
  if (en && snew) {
    for (int a = lane; a < A; a += 32) {
      const bool lg = llegal[a] != 0 && !lt;
      g.prior[(size_t)s * A + a] = lg ? lpolicy[a] : 0.0f;
      g.logit[(size_t)s * A + a] = lg ? llogit[a] : 0.0f;
      g.legal[(size_t)s * A + a] = lg ? 1 : 0;
    }
    const bool edge = sp >= 0 && sp < N && sa >= 0 && sa < A;
    if (lane == 0) expand_node(p, g, sh, b, s, sp, sa, edge, lt, lturn, lvalue, lreward, num_nodes);
    if (p.use_gumbel && edge && sp == 0 && lane == (sa & 31)) s_rci[sa] = s;  // the root's row
  }
  __syncwarp();
  if (p.use_gumbel && en && snew && s == 0) {  // the root rewritten
    for (int a = lane; a < A; a += 32) {
      s_rci[a] = g.ci[a];
      s_rlogit[a] = g.logit[a];
      s_rflag[a] = (g.legal[a] != 0 ? 1 : 0) | (s_rflag[a] & 2);
    }
  }

  // ---- 2. back up, and prefetch the rows of the path into L2 ---------------
  if (en) backup(p, g, sh, N, A, leaf, v_up, rr, lane);
  __syncwarp();
  const QNorm qn = value_bounds(p, sh, N, rr, lane);

  // ---- 3-5a. root statistics, halving tick, Gumbel root step -------------
  int first_action = -1;
  if (p.use_gumbel) {
    const bool flip_root = p.flip && sh.p2[0];
    auto child_visits = [&](int a) -> float {
      const int c = s_rci[a];
      return c >= 0 ? sh.vis[c] : 0.0f;
    };
    unsigned max_count = 0;
    bool reached = true;
    for (int a = lane; a < A; a += 32) {
      const float cv = child_visits(a);
      max_count = max(max_count, fkey(cv));
      if ((s_rflag[a] & 2) && !(cv >= gbudget)) reached = false;
    }
    const float max_c = fkey_inv(__reduce_max_sync(kFull, max_count));
    const bool all_reached = __all_sync(kFull, reached);
    const float sigma = (p.sigma_visit_c + max_c) * p.sigma_scale_c;
    for (int a = lane; a < A; a += 32)  // the halving scores
      s_row[a] = halving_score(qn, s_rlogit[a], (s_rflag[a] & 1) != 0, (s_rflag[a] & 2) != 0,
                               s_rci[a], child_visits(a), sigma, flip_root);
    const float budget = next_budget(p, gm);
    const bool do_halve = all_reached && budget > 0.0f && gm > 2 && en;
    if (do_halve) {  // uniform across the warp
      const int new_m = gm / 2;
      __syncwarp();
      // keep the active actions of rank < new_m, and find the first kept
      // action of the largest score (first_argmax of the kept scores)
      unsigned km = 0, kidx = kNone;
      for (int a = lane; a < A; a += 32) {
        const float ma = s_row[a];
        const bool active = (s_rflag[a] & 2) != 0;
        int rank = 0;
        if (active) {
          for (int j = 0; j < A; ++j) {
            const float mj = s_row[j];
            rank += (mj > ma) || (mj == ma && j < a);
          }
        }
        const bool keep = active && rank < new_m;
        const unsigned kk = fkey(keep ? ma : kNegInf);
        if (kk > km) {
          km = kk;
          kidx = (unsigned)a;
        }
        s_rflag[a] = (s_rflag[a] & 1) | (keep ? 2 : 0);
        g.gactive[a] = keep ? 1 : 0;
      }
      const unsigned kbest = __reduce_max_sync(kFull, km);
      const unsigned bmin = __reduce_min_sync(kFull, km == kbest ? kidx : kNone);
      const float best_visits = bmin == kNone ? 0.0f : child_visits((int)bmin);
      if (lane == 0) {
        p.gm[b] = new_m;
        p.gbudget[b] = best_visits + budget;
      }
      __syncwarp();
    }
    // root step: fewest visits among the active actions, ties -> logit
    first_action = argmax_tiebreak_wide(
        [&](int a) { return (s_rflag[a] & 2) ? -child_visits(a) : kNegInf; },
        [&](int a) { return s_rlogit[a]; }, A, lane);
  }

  // ---- 5b. PUCT descent ---------------------------------------------------
  Sel sel;
  bool done = false;
  int node = 0;
  if (first_action >= 0) {
    const int child = first_action < A ? s_rci[first_action] : -1;
    sel.action = first_action;
    if (lane == 0) sh.path[0] = 1;
    done = settle(sel, sh, 0, first_action, child, lane);
    if (!done) node = child;
  }
  for (int it = 0; it < N && !done; ++it) {  // `done` is uniform
    const int* crow = g.ci + (size_t)node * A;
    const float* prow = g.prior + (size_t)node * A;
    const uint8_t* lrow = g.legal + (size_t)node * A;
    const bool flip_node = p.flip && sh.p2[node];
    const float total_sim = sh.vis[node] - 1.0f;
    const float bias = p.puct_init + logf((1.0f + total_sim + p.puct_base) / p.puct_base);
    const float root_sim = sqrtf(fmaxf(total_sim, 0.0f));
    if (lane == 0) sh.path[node] = 1;
    Level lv;  // one strided pass, as the register kernel's one pass over its slots
    for (int a = lane; a < A; a += 32)
      lv.take(qn, a, crow[a], prow[a], lrow[a] != 0, flip_node, bias, root_sim);
    lv.vis_best = warp_best(lv.vis_best);
    const int spec_c = lv.vis_best.act >= 0 ? crow[lv.vis_best.act] : -1;
    if (spec_c >= 0) {  // the likely next level's rows, on their way to L2
      if (lane == 0) prefetch_l2(g.ci + (size_t)spec_c * A, A * 4);
      if (lane == 1) prefetch_l2(g.prior + (size_t)spec_c * A, A * 4);
      if (lane == 2) prefetch_l2(g.legal + (size_t)spec_c * A, A);
    }
    int act = lv.choose(p.init_q_average, bias, root_sim).act;
    if (act < 0) {  // no legal action: every score is NEG_INF
      act = argmax_tiebreak_wide([&](int) { return kNegInf; }, [&](int a) { return prow[a]; },
                                 A, lane);
    }
    const int child = act < A ? crow[act] : -1;
    done = settle(sel, sh, node, act, child, lane);
    if (!done) node = child;
  }
  __syncwarp();
  write_selection(p, b, sh, sel, lane);
}

using KernelFn = void (*)(const Args);

// the instantiation for A actions: K = ceil(A / 32) slots, rounded up to
// one of the compiled sizes; the wide kernel above 12 slots (A > 384)
KernelFn kernel_for(int A) {
  const int k = (A + 31) / 32;
  if (k <= 1) return tree_step_kernel<1>;
  if (k == 2) return tree_step_kernel<2>;
  if (k == 3) return tree_step_kernel<3>;
  if (k == 4) return tree_step_kernel<4>;
  if (k <= 8) return tree_step_kernel<8>;
  if (k <= kRegisterSlots) return tree_step_kernel<kRegisterSlots>;
  return tree_step_wide_kernel;
}

// warps a block: four for the register kernel; for the wide kernel as many
// as the opt-in shared memory holds, at most four (0: not even one)
int warps_for(int N, int A) {
  if (A <= 32 * kRegisterSlots) return kWarpsPerBlock;
  const size_t per_warp = (size_t)wide_warp_smem_floats(N, A) * sizeof(float);
  return (int)(kMaxBlockSmem / per_warp < (size_t)kWarpsPerBlock ? kMaxBlockSmem / per_warp
                                                                  : (size_t)kWarpsPerBlock);
}

size_t dynamic_smem(int N, int A) {
  if (A <= 32 * kRegisterSlots)
    return (size_t)kWarpsPerBlock * warp_smem_floats(N, A) * sizeof(float);
  return (size_t)warps_for(N, A) * wide_warp_smem_floats(N, A) * sizeof(float);
}

}  // namespace

extern "C" int tree_step_launch(
    int B, int N, int A, int s, int phase,
    int use_gumbel, int flip, int init_q_average, int num_sims,
    int use_rewards, int reward_regime, int value_rescale,
    float puct_base, float puct_init, float log2_m0, float sigma_visit_c, float sigma_scale_c,
    float discount,
    void* visits, void* mean, void* value, void* reward, void* expanded, void* terminal,
    void* parent, void* afp, void* to_play, void* ci, void* prior, void* logit, void* legal,
    void* gactive, void* gm, void* gbudget, void* num_nodes,
    void* sparent, void* saction, void* sleaf, void* snew, void* spath,
    void* lpolicy, void* llogit, void* llegal, void* lterm, void* lvalue, void* lturn,
    void* lreward,
    void* nparent, void* naction, void* nleaf, void* nnew, void* npath,
    void* stream) {
  if (B == 0) return 0;
  const KernelFn kernel = kernel_for(A);
  const int warps = warps_for(N, A);
  if (warps == 0) return kShapeTooLarge;
  Args p;
  p.B = B; p.N = N; p.A = A; p.s = s; p.phase = phase;
  p.use_gumbel = use_gumbel; p.flip = flip; p.init_q_average = init_q_average;
  p.num_sims = num_sims;
  p.use_rewards = use_rewards; p.reward_regime = reward_regime;
  p.value_rescale = value_rescale;
  p.puct_base = puct_base; p.puct_init = puct_init; p.log2_m0 = log2_m0;
  p.sigma_visit_c = sigma_visit_c; p.sigma_scale_c = sigma_scale_c;
  p.discount = discount;
  p.visits = (float*)visits; p.mean = (float*)mean; p.value = (float*)value;
  p.reward = (float*)reward;
  p.expanded = (uint8_t*)expanded; p.terminal = (uint8_t*)terminal;
  p.parent = (int*)parent; p.afp = (int*)afp; p.to_play = (int*)to_play;
  p.ci = (int*)ci; p.prior = (float*)prior; p.logit = (float*)logit;
  p.legal = (uint8_t*)legal; p.gactive = (uint8_t*)gactive;
  p.gm = (int*)gm; p.gbudget = (float*)gbudget; p.num_nodes = (int*)num_nodes;
  p.sparent = (const int*)sparent; p.saction = (const int*)saction;
  p.sleaf = (const int*)sleaf; p.snew = (const uint8_t*)snew;
  p.spath = (const uint8_t*)spath;
  p.lpolicy = (const float*)lpolicy; p.llogit = (const float*)llogit;
  p.llegal = (const uint8_t*)llegal; p.lterm = (const uint8_t*)lterm;
  p.lvalue = (const float*)lvalue; p.lturn = (const int*)lturn;
  p.lreward = (const float*)lreward;
  p.nparent = (int*)nparent; p.naction = (int*)naction; p.nleaf = (int*)nleaf;
  p.nnew = (uint8_t*)nnew; p.npath = (uint8_t*)npath;

  const size_t smem = dynamic_smem(N, A);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block of the
// kernel that a launch with A actions and N nodes runs.
extern "C" int tree_step_attributes(int A, int N, int* regs, int* static_smem,
                                    int* dynamic_smem_bytes) {
  const KernelFn kernel = kernel_for(A);
  if (warps_for(N, A) == 0) return kShapeTooLarge;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem_bytes = (int)dynamic_smem(N, A);
  return 0;
}
