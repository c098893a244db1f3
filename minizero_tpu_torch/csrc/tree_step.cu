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
// register kernel's, and both call the same helpers for every per-action
// stage (expansion of the node, backup, value bounds, the halving score, a
// descent level's candidates, settling the selection); only the reductions
// have block-wide versions. What bounds it: at Amazons' shape (A = 3040,
// N = 17, B = 1024) the expansion's rows in and out and the Gumbel root's
// row, 87 MB (26 us at 3.35 TB/s); a deep PUCT walk's chain of levels
// (row -> candidates -> reduction -> next row). Its design:
//   - One block per game, W warps (wide_warps: ceil(A / 384), at least 2,
//     at most 8), at most 80 registers a thread (__launch_bounds__ with
//     three blocks an SM): three blocks of 8 warps share an SM at A = 3040,
//     as many as its shared memory holds, and B = 1024 games fill the card
//     in under three waves. Action a is handled by thread a % 32W, so a
//     warp's lane holds a % 32 and the warp helpers apply unchanged.
//   - Rows are staged in shared memory by Hopper's bulk copies
//     (cp.async.bulk global -> shared, completing on an mbarrier, issued by
//     thread 0): the Gumbel root's row (child indices, logits, legal and
//     active flags) or the PUCT root's rows are on their way at the start,
//     and each walked node's rows (children_index, prior, legal) in one of
//     two buffers. A bulk copy needs 16-byte alignment and a row starts at
//     node * A * 4 bytes, aligned only when A % 4 == 0 (a legal row when
//     A % 16 == 0): the copy takes the 16-byte aligned window around the
//     row (as prefetch_l2 widens its range) and the row is read at its
//     offset inside the window.
//   - Before the backup, warp 0 notes for every node of the previous path
//     its successor on that path. A level stages the successor of its node
//     into the other buffer before its pass, so that the copy overlaps the
//     pass and the reduction when the walk re-follows the previous path (a
//     deep walk mostly does); when the walk goes elsewhere, it waits out
//     that copy and stages the chosen child. A parity wait cannot tell a
//     phase from the one two ahead, so every thread waits every phase, and
//     a barrier separates the last wait on a buffer from its next copy.
//   - A level's reduction is one round: each warp reduces its lanes with
//     __reduce_*_sync (the best visited child, the unvisited legal action
//     of largest prior, the double sum of q and the count), lane 0 writes
//     the warp's share with the two candidates' children, read from the
//     staged row, to shared memory, one __syncthreads, and every warp
//     reduces the W shares again the same way. Every thread then holds the
//     block's result and nobody reads the level's row after the barrier, so
//     the next level may overwrite it. The shares alternate between two
//     sets of slots, so that a warp that runs ahead to the next round never
//     overwrites a share that another warp is still reading.
//   - The Gumbel root takes one round for its statistics and its step: the
//     largest child visit count, whether every active action reached its
//     budget, and the root step's argmax_tiebreak candidate (the largest
//     score, the largest logit there, the lowest index; and how many
//     actions reach that score, for the one case in which the plain
//     argmax_tiebreak's NEG_INF tie-breaks of the other actions matter,
//     which takes a second round, as does a halving tick).
//   - The halving tick ranks the active set only: the active actions (at
//     most the Gumbel sample size) are compacted, in index order, into the
//     spare buffer by a block scan and ranked pairwise there. A whole-row
//     rank (the register kernel's) also counts the inactive actions, all of
//     score NEG_INF: an active action of score NEG_INF counts the inactive
//     actions of lower index (its index less its position in the compacted
//     set), one below NEG_INF counts every inactive action; the result is
//     the same rank, ties, -0.0 against +0.0 and NEG_INF included.
//   - The node vectors, the backup and the value bounds are the register
//     kernel's: the backup runs on warp 0, every warp takes the bounds.
//   - The expansion writes its rows with plain stores, in 16-byte vectors
//     where A % 4 == 0 and the rows are aligned, several a thread in flight.
//     The walk may stage a row written in this step (the new leaf's, or the
//     parent's edge), so the writers fence the generic proxy against the
//     async one (fence.proxy.async.global) before the barrier that precedes
//     every bulk copy of a walked row.
//   - Shared memory per block (WideLayout): two row buffers of
//     2 * window(4A) + window(A) bytes, the active flags window(A), the node
//     vectors 24N + 3N bytes and 96 W bytes of slots, where window(x) =
//     16 * ceil((x + 15) / 16): 59 KB at A = 3040, N = 17 (three blocks an
//     SM) and 80 KB at N = 801. The launcher refuses a shape past the opt-in
//     227 KB (at N = 17 above A = 12,160) with kShapeTooLarge, which the
//     wrapper raises as a ValueError.
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
constexpr int kShapeTooLarge = -1;           // the block does not fit
constexpr int kMaxWideWarps = 8;
constexpr int kWideMinBlocks = 3;  // blocks an SM the registers must allow
constexpr int kSlotBytes = 48;     // one warp's share of a block reduction

// warps of the wide kernel's block (one game): ceil(A / 384), at least 2,
// at most 8; with at most 80 registers a thread (kWideMinBlocks) three
// blocks of 8 warps fit an SM, as many as the shared memory holds at A = 3040
__host__ __device__ inline int wide_warps(int A) {
  const int w = (A + 383) / 384;
  return w < 2 ? 2 : w > kMaxWideWarps ? kMaxWideWarps : w;
}

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~(size_t)15; }

// bytes of the 16-byte aligned window that a bulk copy of a row of `bytes`
// fetches, wherever the row starts
__host__ __device__ inline size_t row_window(size_t bytes) { return round16(bytes + 15); }

// The wide kernel's shared memory, byte offsets from the block's base: two
// mbarriers, two sets of W reduction slots, two row buffers
// (children_index, prior or logit, legal), the root's active flags, then the
// node vectors (visits, mean, reward, backed-up value [N] floats, parent and
// the next node on the previous path [N] ints; expanded, player-2 flag,
// path [N] bytes).
struct WideLayout {
  size_t slots, ci[2], pr[2], lg[2], act, nodes, bytes, total;
  __host__ __device__ WideLayout(int N, int A, int W) {
    size_t o = 16;
    slots = o;
    o += (size_t)2 * W * kSlotBytes;
    for (int k = 0; k < 2; ++k) {
      ci[k] = o;
      o += row_window((size_t)4 * A);
      pr[k] = o;
      o += row_window((size_t)4 * A);
      lg[k] = o;
      o += row_window(A);
    }
    act = o;
    o += row_window(A);
    nodes = o;
    o += round16((size_t)24 * N);
    bytes = o;
    o += round16((size_t)3 * N);
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

// The 16-byte aligned window around the row [p, p + bytes): where it starts
// in device memory, its length, and where the row starts inside it.
struct Window {
  size_t lo;
  unsigned len, off;
  __device__ __forceinline__ Window(const void* p, size_t bytes) {
    const size_t g = __cvta_generic_to_global(p);
    lo = g & ~(size_t)15;
    off = (unsigned)(g & 15);
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

// Thread 0: stage up to four rows (a null `p` is skipped) into the buffers
// `dst`, completing one phase of `bar`.
__device__ __forceinline__ void stage_rows(uint64_t* bar, unsigned char* const (&dst)[4],
                                           const void* const (&p)[4], const size_t (&bytes)[4]) {
  unsigned total = 0;
  for (int j = 0; j < 4; ++j)
    if (p[j] != nullptr) total += Window(p[j], bytes[j]).len;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(total) : "memory");
  for (int j = 0; j < 4; ++j)
    if (p[j] != nullptr) bulk_copy(dst[j], Window(p[j], bytes[j]), bar);
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

// Keys a round reduces: the largest key and the lowest idx among it (kNone
// with key 0 for "none"), the sum of cnt and the largest mx. Stored in the
// slots as they are.
struct alignas(16) Keys {
  unsigned key = 0, idx = kNone, cnt = 0, mx = 0;
};

__device__ __forceinline__ Keys warp_keys(const Keys& v) {
  Keys r;
  r.key = __reduce_max_sync(kFull, v.key);
  r.idx = __reduce_min_sync(kFull, v.key == r.key ? v.idx : kNone);
  r.cnt = __reduce_add_sync(kFull, v.cnt);
  r.mx = __reduce_max_sync(kFull, v.mx);
  return r;
}

// every thread gets the block's Keys: one barrier
__device__ __forceinline__ Keys block_keys(Team& t, const Keys& v) {
  Keys* s = reinterpret_cast<Keys*>(t.next_slots());
  const Keys w = warp_keys(v);
  if (t.lane == 0) s[t.warp] = w;
  __syncthreads();
  return warp_keys(t.lane < t.W ? s[t.lane] : Keys{});
}

// The Gumbel root's first round: the largest child visit count (mx0),
// whether an active action has not reached its budget (mx1), and the root
// step's argmax_tiebreak candidate: the largest score key s, the largest
// tie-break key t among the actions at s, the lowest such action i, and the
// number of actions at s (c).
struct alignas(16) RootKeys {
  unsigned mx0 = 0, mx1 = 0, s = 0, t = 0, i = kNone, c = 0;
  __device__ __forceinline__ void take(int a, unsigned ks, unsigned kt) {
    if (ks > s) {
      s = ks; t = kt; i = (unsigned)a; c = 1;
    } else if (ks == s) {
      c += 1;
      if (kt > t) {
        t = kt; i = (unsigned)a;
      }
    }
  }
};

__device__ __forceinline__ RootKeys warp_root(const RootKeys& v) {
  RootKeys r;
  r.mx0 = __reduce_max_sync(kFull, v.mx0);
  r.mx1 = __reduce_max_sync(kFull, v.mx1);
  r.s = __reduce_max_sync(kFull, v.s);
  r.t = __reduce_max_sync(kFull, v.s == r.s ? v.t : 0u);
  r.i = __reduce_min_sync(kFull, v.s == r.s && v.t == r.t ? v.i : kNone);
  r.c = __reduce_add_sync(kFull, v.s == r.s ? v.c : 0u);
  return r;
}

__device__ __forceinline__ RootKeys block_root(Team& t, const RootKeys& v) {
  RootKeys* s = reinterpret_cast<RootKeys*>(t.next_slots());
  const RootKeys w = warp_root(v);
  if (t.lane == 0) s[t.warp] = w;
  __syncthreads();
  return warp_root(t.lane < t.W ? s[t.lane] : RootKeys{});
}

// exclusive prefix sum of v over the threads in order, and the total
struct Scan {
  unsigned before, total;
};

__device__ __forceinline__ Scan block_scan(Team& t, unsigned v) {
  unsigned x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (t.lane >= o) x += y;
  }
  unsigned* s = reinterpret_cast<unsigned*>(t.next_slots());
  if (t.lane == 31) s[t.warp] = x;
  __syncthreads();
  unsigned before = 0, total = 0;
  for (int w = 0; w < t.W; ++w) {
    const unsigned c = s[w];
    if (w < t.warp) before += c;
    total += c;
  }
  return Scan{before + x - v, total};
}

// A descent level's candidates reduced over the block, with the children
// of the two (read from the staged row before the barrier, so that no
// thread reads the row after it).
struct LevelSum {
  Best vis_best;
  int vis_child;
  float open_p;
  int open_a, open_child;
  double sum_q;
  unsigned nv;
};

struct alignas(16) LevelSlot {
  float score, tb;
  int act, vis_child;
  float open_p;
  int open_a, open_child;
  unsigned nv;
  double sum_q;
  double pad;
};
static_assert(sizeof(LevelSlot) == kSlotBytes, "a level's slot");

// The lanes' best candidate under `better` and the lane that holds it (-1:
// none); lanes hold arbitrary actions, so the lane is found by a ballot.
__device__ __forceinline__ int lanes_best(Best& v) {
  const unsigned ks = v.act >= 0 ? fkey(v.score) : 0u;
  const unsigned kmax = __reduce_max_sync(kFull, ks);
  const unsigned kt = (v.act >= 0 && ks == kmax) ? fkey(v.tb) : 0u;
  const unsigned tmax = __reduce_max_sync(kFull, kt);
  const unsigned ka = (v.act >= 0 && ks == kmax && kt == tmax) ? (unsigned)v.act : kNone;
  const unsigned amin = __reduce_min_sync(kFull, ka);
  if (amin == kNone) {
    v = Best{0.0f, 0.0f, -1};
    return -1;
  }
  const int src = __ffs(__ballot_sync(kFull, ka == amin)) - 1;
  v = Best{__shfl_sync(kFull, v.score, src), __shfl_sync(kFull, v.tb, src), (int)amin};
  return src;
}

// The largest prior among the lanes' unvisited actions, lowest action on
// ties, and the lane that holds it (-1: none).
__device__ __forceinline__ int lanes_open(float& open_p, int& open_a) {
  const unsigned kp = open_a >= 0 ? fkey(open_p) : 0u;
  const unsigned kpmax = __reduce_max_sync(kFull, kp);
  const unsigned omin =
      __reduce_min_sync(kFull, (open_a >= 0 && kp == kpmax) ? (unsigned)open_a : kNone);
  if (omin == kNone) {
    open_a = -1;
    return -1;
  }
  const int src = __ffs(__ballot_sync(kFull, open_a >= 0 && (unsigned)open_a == omin)) - 1;
  open_p = __shfl_sync(kFull, open_p, src);
  open_a = (int)omin;
  return src;
}

// One round: every thread gets the level's best visited child, its
// unvisited legal action of largest prior, their children in the staged
// row `crow`, and the visited children's q summed (double) and counted.
__device__ __forceinline__ LevelSum block_level(Team& t, const Level& lv, const int* crow) {
  LevelSlot* s = reinterpret_cast<LevelSlot*>(t.next_slots());
  Best vb = lv.vis_best;
  lanes_best(vb);
  float op = lv.open_p;
  int oa = lv.open_a;
  lanes_open(op, oa);
  const double sq = warp_sum(lv.sum_q);
  const unsigned nv = __reduce_add_sync(kFull, lv.num_visited);
  if (t.lane == 0)
    s[t.warp] = LevelSlot{vb.score, vb.tb, vb.act, vb.act >= 0 ? crow[vb.act] : -1, op, oa,
                          oa >= 0 ? crow[oa] : -1, nv, sq, 0.0};
  __syncthreads();
  LevelSlot x{0.0f, 0.0f, -1, -1, 0.0f, -1, -1, 0u, 0.0, 0.0};
  if (t.lane < t.W) x = s[t.lane];
  LevelSum r;
  r.vis_best = Best{x.score, x.tb, x.act};
  const int vsrc = lanes_best(r.vis_best);
  r.vis_child = __shfl_sync(kFull, x.vis_child, vsrc < 0 ? 0 : vsrc);
  r.open_p = x.open_p;
  r.open_a = x.open_a;
  const int osrc = lanes_open(r.open_p, r.open_a);
  r.open_child = __shfl_sync(kFull, x.open_child, osrc < 0 ? 0 : osrc);
  r.sum_q = warp_sum(x.sum_q);
  r.nv = __reduce_add_sync(kFull, x.nv);
  return r;
}

// Level::choose on the block's sums
__device__ __forceinline__ Best choose_level(const LevelSum& r, bool init_q_average, float bias,
                                             float root_sim) {
  const float sq = (float)r.sum_q;
  const float nv = (float)r.nv;
  float init_q;
  if (init_q_average) init_q = nv > 0.0f ? sq / fmaxf(nv, 1.0f) : 1.0f;
  else init_q = (sq - 1.0f) / (nv + 1.0f);
  Best best = r.vis_best;
  if (r.open_a >= 0) {
    const float u = bias * r.open_p * root_sim / (1.0f + 0.0f);  // no visits
    const Best open{u + init_q, r.open_p, r.open_a};
    if (better(open, best)) best = open;
  }
  return best;
}

// the lowest action whose flag is clear (A if none), each warp on its own
__device__ __forceinline__ int first_clear(const uint8_t* flags, int A, int lane) {
  for (int a0 = 0; a0 < A; a0 += 32) {
    const int a = a0 + lane;
    const unsigned m = __ballot_sync(kFull, a < A && flags[a] == 0);
    if (m) return a0 + __ffs(m) - 1;
  }
  return A;
}

// Thread 0: stage a walked node's rows (children_index, prior, legal).
__device__ __forceinline__ void stage_walk(const Game& g, uint64_t* bar, unsigned char* ci,
                                           unsigned char* pr, unsigned char* lg, int node, int A) {
  const size_t o = (size_t)node * A;
  unsigned char* const dst[4] = {ci, pr, lg, nullptr};
  const void* const src[4] = {g.ci + o, g.prior + o, g.legal + o, nullptr};
  const size_t bytes[4] = {(size_t)4 * A, (size_t)4 * A, (size_t)A, 0};
  stage_rows(bar, dst, src, bytes);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (__cvta_generic_to_global(p) & 15) == 0;
}

// The expansion's rows: prior, logit and legal of slot s from the leaf's
// (masked by legality and the terminal flag), four actions a thread in
// flight; in 16-byte vectors when A % 4 == 0 and the rows are aligned.
__device__ __forceinline__ void expand_rows(const float* lpolicy, const float* llogit,
                                            const uint8_t* llegal, float* prior_s,
                                            float* logit_s, uint8_t* legal_s, bool lt, int A,
                                            int tid, int T) {
  const bool vec = A % 4 == 0 && aligned16(lpolicy) && aligned16(llogit) &&
                   aligned16(prior_s) && aligned16(logit_s) &&
                   ((__cvta_generic_to_global(llegal) | __cvta_generic_to_global(legal_s)) & 3) == 0;
  if (vec) {
    const int A4 = A / 4;
    const float4* pol4 = reinterpret_cast<const float4*>(lpolicy);
    const float4* lgt4 = reinterpret_cast<const float4*>(llogit);
    const uint32_t* leg4 = reinterpret_cast<const uint32_t*>(llegal);
    float4* pri4 = reinterpret_cast<float4*>(prior_s);
    float4* log4 = reinterpret_cast<float4*>(logit_s);
    uint32_t* out4 = reinterpret_cast<uint32_t*>(legal_s);
    for (int q0 = tid; q0 < A4; q0 += 2 * T) {
      float4 pol[2], lgt[2];
      uint32_t lg[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = q0 + j * T;
        pol[j] = q < A4 ? pol4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        lgt[j] = q < A4 ? lgt4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
          log4[q] = make_float4(l0 ? lgt[j].x : 0.0f, l1 ? lgt[j].y : 0.0f, l2 ? lgt[j].z : 0.0f,
                                l3 ? lgt[j].w : 0.0f);
          out4[q] = (l0 ? 1u : 0u) | (l1 ? 0x100u : 0u) | (l2 ? 0x10000u : 0u) |
                    (l3 ? 0x1000000u : 0u);
        }
      }
    }
    return;
  }
  for (int a0 = tid; a0 < A; a0 += 4 * T) {
    float pol[4], lgt[4];
    bool lg[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + j * T;
      lg[j] = a < A && llegal[a] != 0 && !lt;
      pol[j] = a < A ? lpolicy[a] : 0.0f;
      lgt[j] = a < A ? llogit[a] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + j * T;
      if (a < A) {
        prior_s[a] = lg[j] ? pol[j] : 0.0f;
        logit_s[a] = lg[j] ? lgt[j] : 0.0f;
        legal_s[a] = lg[j] ? 1 : 0;
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxWideWarps, kWideMinBlocks)
tree_step_wide_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char wsm[];
  const int b = blockIdx.x;
  const int N = p.N, A = p.A, s = p.s;
  Team team{(int)threadIdx.x, (int)blockDim.x, (int)(blockDim.x >> 5), (int)(threadIdx.x >> 5),
            (int)(threadIdx.x & 31), nullptr, 0u};
  const int tid = team.tid, T = team.T;
  const WideLayout lay(N, A, team.W);
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsm);
  team.slots = wsm + lay.slots;
  unsigned char* const ci_buf[2] = {wsm + lay.ci[0], wsm + lay.ci[1]};
  unsigned char* const pr_buf[2] = {wsm + lay.pr[0], wsm + lay.pr[1]};
  unsigned char* const lg_buf[2] = {wsm + lay.lg[0], wsm + lay.lg[1]};
  float* nf = reinterpret_cast<float*>(wsm + lay.nodes);
  int* nxt = reinterpret_cast<int*>(nf + 5 * N);  // the next node on the previous path
  uint8_t* nb = wsm + lay.bytes;
  const Nodes sh{nf, nf + N, nf + 2 * N, nf + 3 * N, reinterpret_cast<int*>(nf + 4 * N),
                 nb, nb + N, nb + 2 * N};

  const bool en = p.phase > 0;
  const bool rr = p.reward_regime != 0;
  const Game g = game_of(p, b);
  // the root's rows: staged right away, unless this step rewrites them (a
  // new leaf at slot 0), then once the expansion has written them
  const bool late_root = en && s == 0 && p.snew[b] != 0;
  auto stage_root = [&]() {
    if (p.use_gumbel) {
      unsigned char* const dst[4] = {ci_buf[0], pr_buf[0], lg_buf[0], wsm + lay.act};
      const void* const src[4] = {g.ci, g.logit, g.legal, g.gactive};
      const size_t bytes[4] = {(size_t)4 * A, (size_t)4 * A, (size_t)A, (size_t)A};
      stage_rows(&bar[0], dst, src, bytes);
    } else {
      stage_walk(g, &bar[0], ci_buf[0], pr_buf[0], lg_buf[0], 0, A);
    }
  };
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0 && !late_root) stage_root();

  // ---- 0. the selection, the leaf, the Gumbel state, then the node
  // vectors (and the previous path) into shared memory ----------------------
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
  }
  for (int n = tid; n < N; n += T) {
    const float v = g.vis[n], m = g.mean[n];
    const uint8_t e = g.expanded[n];
    const int tp = g.to_play[n];
    const float r = rr ? g.reward[n] : 0.0f;
    const int par = g.parent[n];
    const uint8_t on = en ? g.spath[n] : 0;
    sh.vis[n] = v;
    sh.mean[n] = m;
    sh.reward[n] = r;
    sh.parent[n] = par;
    nxt[n] = -1;
    sh.exp[n] = e;
    sh.p2[n] = tp == 2;
    sh.path[n] = on;
  }

  // ---- 1. expand the new leaf at slot s ----------------------------------
  const bool edge = sp >= 0 && sp < N && sa >= 0 && sa < A;
  if (en && snew) {
    expand_rows(p.lpolicy + (size_t)b * A, p.llogit + (size_t)b * A, p.llegal + (size_t)b * A,
                g.prior + (size_t)s * A, g.logit + (size_t)s * A, g.legal + (size_t)s * A, lt,
                A, tid, T);
    if (tid == 0) expand_node(p, g, sh, b, s, sp, sa, edge, lt, lturn, lvalue, lreward, num_nodes);
    fence_async_global();  // a bulk copy below may stage what was written here
  }
  __syncthreads();

  // ---- 2. warp 0: the next node of every node on the previous path (the
  // walk's prediction), then the backup, and the rows of the path prefetched
  // into L2; the root's rows land (the expansion's edge into the root
  // patched) -----------------------------------------------------------------
  unsigned par[2] = {0u, 0u};
  if (team.warp == 0) {
    if (tid == 0 && late_root) stage_root();
    if (en) {
      for (int n = team.lane; n < N; n += 32) {
        const int up = sh.parent[n];
        if ((sh.path[n] || n == leaf) && up >= 0 && up < N) nxt[up] = n;
      }
      __syncwarp();
      backup(p, g, sh, N, A, leaf, v_up, rr, team.lane);
    }
    if (tid == 0 && !late_root) {
      unsigned ph = 0u;
      mbar_wait(&bar[0], ph);
      if (en && snew && edge && sp == 0) staged<int>(ci_buf[0], g.ci)[sa] = s;
      fence_async_shared();  // buffer 0 is staged again later in the walk
    }
  }
  __syncthreads();
  mbar_wait(&bar[0], par[0]);
  const QNorm qn = value_bounds(p, sh, N, rr, team.lane);
  const int* rci = staged<int>(ci_buf[0], g.ci);

  // ---- 3-5a. root statistics, halving tick, Gumbel root step -------------
  int first_action = -1;
  if (p.use_gumbel) {
    const float* rlogit = staged<float>(pr_buf[0], g.logit);
    const uint8_t* rlegal = staged<uint8_t>(lg_buf[0], g.legal);
    uint8_t* ractive = staged<uint8_t>(wsm + lay.act, g.gactive);
    const bool flip_root = p.flip && sh.p2[0];
    auto child_visits = [&](int a) -> float {
      const int c = rci[a];
      return c >= 0 ? sh.vis[c] : 0.0f;
    };
    const unsigned neg = fkey(kNegInf);
    // one round: the largest child visit count, whether every active
    // action reached its budget, and the root step's candidate (fewest
    // visits among the active actions, ties -> logit, then lowest index)
    RootKeys rk;
    for (int a = tid; a < A; a += T) {
      const float cv = child_visits(a);
      const bool active = ractive[a] != 0;
      rk.mx0 = max(rk.mx0, fkey(cv));
      if (active && !(cv >= gbudget)) rk.mx1 = 1u;
      rk.take(a, active ? fkey(-cv) : neg, fkey(rlogit[a]));
    }
    rk = block_root(team, rk);
    const float max_c = fkey_inv(rk.mx0);
    const bool all_reached = rk.mx1 == 0u;
    const float sigma = (p.sigma_visit_c + max_c) * p.sigma_scale_c;
    const float budget = next_budget(p, gm);
    const bool do_halve = all_reached && budget > 0.0f && gm > 2 && en;
    unsigned root_key = rk.s;
    if (do_halve) {  // uniform across the block
      const int new_m = gm / 2;
      // the active actions and their halving scores, compacted in index
      // order into the spare buffer: thread t scans a run of actions
      int* cidx = reinterpret_cast<int*>(ci_buf[1]);
      float* cscore = reinterpret_cast<float*>(pr_buf[1]);
      const int run = (A + T - 1) / T;
      const int a0 = min(A, tid * run), a1 = min(A, a0 + run);
      unsigned cnt = 0;
      for (int a = a0; a < a1; ++a) cnt += ractive[a] != 0;
      const Scan sc = block_scan(team, cnt);
      int pos = (int)sc.before;
      for (int a = a0; a < a1; ++a) {
        if (ractive[a]) {
          cidx[pos] = a;
          cscore[pos] = halving_score(qn, rlogit[a], rlegal[a] != 0, true, rci[a], child_visits(a),
                                      sigma, flip_root);
          ++pos;
        }
      }
      __syncthreads();
      const int M = (int)sc.total;
      // rank among the active set, plus the inactive actions (all NEG_INF)
      // that the whole row's rank counts; keep the top new_m
      Keys kk;  // key/idx: the kept scores' first maximum; cnt: kept; mx: root-step key
      for (int i = tid; i < M; i += T) {
        const float mi = cscore[i];
        const int ai = cidx[i];
        int rank = mi == kNegInf ? ai - i : (mi < kNegInf ? A - M : 0);
        for (int j = 0; j < M; ++j) {
          const float mj = cscore[j];
          rank += (mj > mi) || (mj == mi && j < i);
        }
        const bool keep = rank < new_m;
        ractive[ai] = keep ? 1 : 0;
        g.gactive[ai] = keep ? 1 : 0;
        if (keep) {
          kk.cnt += 1u;
          const unsigned key = fkey(mi);
          if (key > kk.key) {
            kk.key = key;
            kk.idx = (unsigned)ai;
          }
          kk.mx = max(kk.mx, fkey(-child_visits(ai)));
        }
      }
      fence_async_shared();  // both buffers are staged again in the walk
      kk = block_keys(team, kk);
      // first_argmax over the whole row, where every action not kept
      // scores NEG_INF: the first kept maximum, or the lowest action not
      // kept when NEG_INF reaches the maximum
      const bool others = (unsigned)A > kk.cnt;
      int best = kk.idx == kNone ? A : (int)kk.idx;
      if (others && neg >= kk.key) {
        const int clear = first_clear(ractive, A, team.lane);
        best = neg > kk.key ? clear : min(best, clear);
      }
      const float best_visits = best < A ? child_visits(best) : 0.0f;
      if (tid == 0) {
        p.gm[b] = new_m;
        p.gbudget[b] = best_visits + budget;
      }
      root_key = others ? max(kk.mx, neg) : kk.mx;
    }
    if (!do_halve && (rk.t > neg || rk.c == (unsigned)A)) {
      first_action = rk.i == kNone ? A : (int)rk.i;
    } else {
      // argmax_tiebreak in full: the largest logit among the actions at the
      // largest score, every other action NEG_INF, then the lowest index
      Keys r;
      for (int a = tid; a < A; a += T) {
        const unsigned ks = fkey(ractive[a] ? -child_visits(a) : kNegInf);
        const unsigned kt = ks == root_key ? fkey(rlogit[a]) : neg;
        if (kt > r.key) {
          r.key = kt;
          r.idx = (unsigned)a;
        }
      }
      r = block_keys(team, r);
      first_action = r.idx == kNone ? A : (int)r.idx;
    }
  }

  // ---- 5b. PUCT descent ---------------------------------------------------
  // A level stages the next node that the previous path predicts into the
  // other buffer before its pass; when the walk goes elsewhere it waits out
  // that copy and stages the chosen child. No thread reads a level's row
  // after its round's barrier, so the next level may overwrite it.
  Sel sel;
  bool done = false;
  int node = 0, k = 0;
  bool pending[2] = {false, false};
  if (first_action >= 0) {
    const int child = first_action < A ? rci[first_action] : -1;
    sel.action = first_action;
    if (tid == 0) sh.path[0] = 1;
    done = settle(sel, sh, 0, first_action, child, tid);
    if (!done) {
      node = child;
      k = 1;
      if (tid == 0) stage_walk(g, &bar[1], ci_buf[1], pr_buf[1], lg_buf[1], node, A);
      pending[1] = true;
      __syncthreads();  // the root's row is read no more: buffer 0 is free
    }
  }
  for (int it = 0; it < N && !done; ++it) {  // `done` is uniform
    if (pending[k]) {
      mbar_wait(&bar[k], par[k]);
      pending[k] = false;
    }
    const int pred = nxt[node];
    if (pred >= 0) {
      if (tid == 0) stage_walk(g, &bar[k ^ 1], ci_buf[k ^ 1], pr_buf[k ^ 1], lg_buf[k ^ 1], pred, A);
      pending[k ^ 1] = true;
    }
    const size_t o = (size_t)node * A;
    const int* crow = staged<int>(ci_buf[k], g.ci + o);
    const float* prow = staged<float>(pr_buf[k], g.prior + o);
    const uint8_t* lrow = staged<uint8_t>(lg_buf[k], g.legal + o);
    const bool flip_node = p.flip && sh.p2[node];
    const float total_sim = sh.vis[node] - 1.0f;
    const float bias = p.puct_init + logf((1.0f + total_sim + p.puct_base) / p.puct_base);
    const float root_sim = sqrtf(fmaxf(total_sim, 0.0f));
    if (tid == 0) sh.path[node] = 1;
    Level lv;
    for (int a = tid; a < A; a += T)
      lv.take(qn, a, crow[a], prow[a], lrow[a] != 0, flip_node, bias, root_sim);
    const LevelSum r = block_level(team, lv, crow);
    int act = choose_level(r, p.init_q_average, bias, root_sim).act;
    int child = act < 0 ? -1 : act == r.vis_best.act ? r.vis_child : r.open_child;
    if (act < 0) {  // no legal action: every score is NEG_INF, the largest prior wins
      Keys q;
      for (int a = tid; a < A; a += T) {
        const unsigned kp = fkey(prow[a]);
        if (kp > q.key) {
          q.key = kp;
          q.idx = (unsigned)a;
        }
      }
      q = block_keys(team, q);
      act = q.idx == kNone ? A : (int)q.idx;
      child = act < A ? crow[act] : -1;
      __syncthreads();  // the row is read no more
    }
    done = settle(sel, sh, node, act, child, tid);
    if (!done) {
      if (child != pred) {  // the walk left the previous path
        if (pending[k ^ 1]) {
          mbar_wait(&bar[k ^ 1], par[k ^ 1]);
          // every thread has seen that phase complete before the barrier
          // starts the next: a parity wait cannot tell them apart
          __syncthreads();
        }
        if (tid == 0) stage_walk(g, &bar[k ^ 1], ci_buf[k ^ 1], pr_buf[k ^ 1], lg_buf[k ^ 1], child, A);
        pending[k ^ 1] = true;
      }
      node = child;
      k ^= 1;
    }
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
  if (k <= 1) return tree_step_kernel<1>;
  if (k == 2) return tree_step_kernel<2>;
  if (k == 3) return tree_step_kernel<3>;
  if (k == 4) return tree_step_kernel<4>;
  if (k <= 8) return tree_step_kernel<8>;
  if (k <= kRegisterSlots) return tree_step_kernel<kRegisterSlots>;
  return tree_step_wide_kernel;
}

bool is_wide(int A) { return A > 32 * kRegisterSlots; }

// dynamic shared memory a block: the register kernel's four warps, or the
// wide kernel's one game
size_t dynamic_smem(int N, int A) {
  if (!is_wide(A)) return (size_t)kWarpsPerBlock * warp_smem_floats(N, A) * sizeof(float);
  return WideLayout(N, A, wide_warps(A)).total;
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
  const bool wide = is_wide(A);
  const size_t smem = dynamic_smem(N, A);
  // either kernel: the register kernel's four warps pass the limit too
  // (past N = 2,512 at A = 82)
  if (smem > kMaxBlockSmem) return kShapeTooLarge;
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
// kernel that a launch with A actions and N nodes runs.
extern "C" int tree_step_attributes(int A, int N, int* regs, int* static_smem,
                                    int* dynamic_smem_bytes) {
  const KernelFn kernel = kernel_for(A);
  if (dynamic_smem(N, A) > kMaxBlockSmem) return kShapeTooLarge;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem_bytes = (int)dynamic_smem(N, A);
  return 0;
}
