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

  float* vis = p.visits + (size_t)b * N;
  float* mean = p.mean + (size_t)b * N;
  float* value = p.value + (size_t)b * N;
  float* reward = p.reward + (size_t)b * N;
  uint8_t* expanded = p.expanded + (size_t)b * N;
  uint8_t* terminal = p.terminal + (size_t)b * N;
  int* parent = p.parent + (size_t)b * N;
  int* to_play = p.to_play + (size_t)b * N;
  int* ci = p.ci + (size_t)b * N * A;
  float* prior = p.prior + (size_t)b * N * A;
  float* logit = p.logit + (size_t)b * N * A;
  uint8_t* legal = p.legal + (size_t)b * N * A;
  uint8_t* gactive = p.gactive + (size_t)b * A;
  const uint8_t* spath = p.spath + (size_t)b * N;

  float* s_vis = smem + (size_t)warp * warp_smem_floats(N, A);
  float* s_mean = s_vis + N;
  float* s_reward = s_mean + N;
  float* s_u = s_reward + N;
  int* s_parent = reinterpret_cast<int*>(s_u + N);
  float* s_row = reinterpret_cast<float*>(s_parent + N);
  uint8_t* s_exp = reinterpret_cast<uint8_t*>(s_row + A);
  uint8_t* s_p2 = s_exp + N;
  uint8_t* s_path = s_p2 + N;

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
  const float v_up = snew ? lvalue : (en && leaf >= 0) ? value[leaf] : 0.0f;
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
      r_ci[k] = a < A ? ci[a] : -1;
      r_logit[k] = a < A ? logit[a] : 0.0f;
      r_legal[k] = a < A && legal[a] != 0;
      r_active[k] = a < A && gactive[a] != 0;
    }
  }
  // s_path holds the previous path until the backup has read it
  for (int n0 = 0; n0 < N; n0 += 4 * 32) {
    float v[4], m[4], r[4];
    int par[4], tp[4];
    uint8_t e[4], on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      const bool in = n < N;
      v[j] = in ? vis[n] : 0.0f;
      m[j] = in ? mean[n] : 0.0f;
      e[j] = in ? expanded[n] : 0;
      tp[j] = in ? to_play[n] : 0;
      r[j] = in && rr ? reward[n] : 0.0f;
      par[j] = in && rr ? parent[n] : -1;
      on[j] = in && en ? spath[n] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * j + lane;
      if (n < N) {
        s_vis[n] = v[j];
        s_mean[n] = m[j];
        s_reward[n] = r[j];
        s_parent[n] = par[j];
        s_exp[n] = e[j];
        s_p2[n] = tp[j] == 2;
        s_path[n] = on[j];
      }
    }
  }

  // ---- 1. expand the new leaf at slot s ----------------------------------
  if (en && snew) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      if (a < A) {
        const bool lg = llg[k] && !lt;
        prior[(size_t)s * A + a] = lg ? lpol[k] : 0.0f;
        logit[(size_t)s * A + a] = lg ? llog[k] : 0.0f;
        legal[(size_t)s * A + a] = lg ? 1 : 0;
      }
    }
    const bool edge = sp >= 0 && sp < N && sa >= 0 && sa < A;
    if (lane == 0) {
      expanded[s] = lt ? 0 : 1;
      terminal[s] = lt ? 1 : 0;
      parent[s] = sp;
      p.afp[(size_t)b * N + s] = sa;
      to_play[s] = lturn;
      value[s] = lvalue;
      s_exp[s] = lt ? 0 : 1;
      s_p2[s] = lturn == 2;
      s_parent[s] = sp;
      if (p.use_rewards) {
        reward[s] = lreward;
        s_reward[s] = lreward;
      }
      p.num_nodes[b] = max(num_nodes, s + 1);
      if (edge) ci[(size_t)sp * A + sa] = s;
    }
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
      r_ci[k] = a < A ? ci[a] : -1;
      r_logit[k] = a < A ? logit[a] : 0.0f;
      r_legal[k] = a < A && legal[a] != 0;
    }
  }

  // ---- 2. back up, and prefetch the rows of the path into L2 ---------------
  if (en) {
    for (int n = lane; n < N; n += 32) {
      const bool on_path = s_path[n] != 0;
      s_path[n] = 0;
      if (on_path) {
        prefetch_l2(ci + (size_t)n * A, A * 4);
        prefetch_l2(prior + (size_t)n * A, A * 4);
        prefetch_l2(legal + (size_t)n * A, A);
      }
      // board regime: every path node receives the same value
      if (!rr && (on_path || n == leaf)) {
        const float c = s_vis[n] + 1.0f;
        const float m = s_mean[n] + (v_up - s_mean[n]) / fmaxf(c, 1.0f);
        s_vis[n] = c;
        s_mean[n] = m;
        vis[n] = c;
        mean[n] = m;
      }
    }
    if (rr) {
      // leaf -> root along the parent pointers (this step's expansion
      // included): one lane computes the value each node receives,
      // u = reward[node] + discount * u between nodes, serially as the
      // plain version does, and marks the node; a path has at most N nodes.
      // Then every lane updates its marked nodes.
      __syncwarp();
      if (lane == 0) {
        float u = v_up;
        int cur = leaf;
        for (int it = 0; it < N && cur >= 0; ++it) {
          s_u[cur] = u;
          s_path[cur] = 1;
          u = s_reward[cur] + p.discount * u;
          cur = s_parent[cur];
        }
      }
      __syncwarp();
      for (int n = lane; n < N; n += 32) {
        if (s_path[n]) {
          s_path[n] = 0;
          const float c = s_vis[n] + 1.0f;
          const float m = s_mean[n] + (s_u[n] - s_mean[n]) / fmaxf(c, 1.0f);
          s_vis[n] = c;
          s_mean[n] = m;
          vis[n] = c;
          mean[n] = m;
        }
      }
    }
  }
  __syncwarp();

  // per-node raw q and, with value_rescale, the tree's value bounds over the
  // visited nodes (mcts.cpp:40-53, 219-228); fixed for the rest of the step
  auto qnode = [&](int n) -> float {
    return rr ? s_reward[n] + p.discount * s_mean[n] : s_mean[n];
  };
  float q_lo = 0.0f, q_hi = 0.0f;
  bool q_enough = false;
  if (p.value_rescale) {
    unsigned lo = fkey(3.4e38f), hi = fkey(kNegInf);
    unsigned visited = 0;
    for (int n = lane; n < N; n += 32) {
      if (s_vis[n] > 0.0f) {
        const unsigned q = fkey(qnode(n));
        lo = min(lo, q);
        hi = max(hi, q);
        visited += 1;
      }
    }
    q_lo = fkey_inv(__reduce_min_sync(kFull, lo));
    q_hi = fkey_inv(__reduce_max_sync(kFull, hi));
    q_enough = __reduce_add_sync(kFull, visited) >= 2;
  }
  // value rescale (1 while fewer than 2 nodes are visited), then the player
  // flip (mcts._normalize_q)
  auto norm_q = [&](float q, bool flip) -> float {
    if (p.value_rescale) {
      if (q_enough) {
        float sc = (q - q_lo) / fmaxf(q_hi - q_lo, 1e-8f);
        sc = 2.0f * sc - 1.0f;
        q = fminf(fmaxf(sc, -1.0f), 1.0f);
      } else {
        q = 1.0f;
      }
    }
    return flip ? -q : q;
  };

  // ---- 3-5a. root statistics, halving tick, Gumbel root step -------------
  int first_action = -1;
  if (p.use_gumbel) {
    const bool flip_root = p.flip && s_p2[0];
    float cv[K], sig[K];
    unsigned max_count = 0;
    bool reached = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = r_ci[k];
      cv[k] = c >= 0 ? s_vis[c] : 0.0f;
      if (lane + 32 * k < A) {
        max_count = max(max_count, fkey(cv[k]));
        if (r_active[k] && !(cv[k] >= gbudget)) reached = false;
      }
    }
    const float max_c = fkey_inv(__reduce_max_sync(kFull, max_count));
    const bool all_reached = __all_sync(kFull, reached);
    const float sigma = (p.sigma_visit_c + max_c) * p.sigma_scale_c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = r_ci[k];
      const float q_vis = (c >= 0 && cv[k] > 0.0f) ? norm_q(qnode(c), flip_root) : 0.0f;
      float score = r_logit[k] + sigma * q_vis;
      if (!(r_legal[k] && cv[k] > 0.0f)) score = kNegInf;
      sig[k] = r_active[k] ? score : kNegInf;
    }
    const float next_budget =
        floorf((float)p.num_sims / (p.log2_m0 * fmaxf((float)gm / 2.0f, 1.0f)));
    const bool do_halve = all_reached && next_budget > 0.0f && gm > 2 && en;
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
        if (a < A) gactive[a] = keep ? 1 : 0;
      }
      const int best = first_argmax(kept, A, lane);
      const float best_visits = lane_value(cv, best);
      if (lane == 0) {
        p.gm[b] = new_m;
        p.gbudget[b] = best_visits + next_budget;
      }
    }
    // root step: fewest visits among the active actions, ties -> logit
    float count_key[K];
#pragma unroll
    for (int k = 0; k < K; ++k) count_key[k] = r_active[k] ? -cv[k] : kNegInf;
    first_action = argmax_tiebreak(count_key, r_logit, A, lane);
  }

  // ---- 5b. PUCT descent ---------------------------------------------------
  int sel_parent = 0, sel_action = 0, sel_leaf = -1;
  bool sel_new = false, done = false;
  int node = 0;
  if (first_action >= 0) {
    const int child = lane_value(r_ci, first_action);
    sel_action = first_action;
    if (lane == 0) s_path[0] = 1;
    if (child < 0) {
      sel_new = true;
      done = true;
    } else if (!s_exp[child]) {
      sel_leaf = child;
      if (lane == 0) s_path[child] = 1;
      done = true;
    } else {
      node = child;
    }
  }
  Row<K> row;
  if (!done)
    load_row(row, ci + (size_t)node * A, prior + (size_t)node * A, legal + (size_t)node * A, A,
             lane);
  for (int it = 0; it < N && !done; ++it) {  // `done` is uniform
    const bool flip_node = p.flip && s_p2[node];
    const float total_sim = s_vis[node] - 1.0f;
    const float bias = p.puct_init + logf((1.0f + total_sim + p.puct_base) / p.puct_base);
    const float root_sim = sqrtf(fmaxf(total_sim, 0.0f));
    if (lane == 0) s_path[node] = 1;
    // one pass: the lane's best visited legal child, its unvisited legal
    // lane of largest prior, and its share of the visited children's q.
    // An unvisited lane scores (bias * prior) * root_sim / 1 + init_q: the
    // same init_q for all of them, non-decreasing in the prior (bias >= 0,
    // root_sim >= 0, rounding is monotone), so the one of largest prior
    // (then lowest action) is the best of them under the argmax's order.
    Best vis_best{0.0f, 0.0f, -1};
    float open_p = 0.0f;
    int open_a = -1;
    double sum_q = 0.0;
    unsigned num_visited = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane + 32 * k;
      const int c = row.c[k];
      const float cv = c >= 0 ? s_vis[c] : 0.0f;
      if (c >= 0 && cv > 0.0f) {
        const float q = norm_q(qnode(c), flip_node);
        sum_q += (double)q;
        num_visited += 1;
        if (row.lg[k]) {
          const float u = bias * row.pr[k] * root_sim / (1.0f + cv);
          const Best cand{u + q, row.pr[k], a};
          if (better(cand, vis_best)) vis_best = cand;
        }
      } else if (row.lg[k] && (open_a < 0 || row.pr[k] > open_p)) {
        open_p = row.pr[k];
        open_a = a;
      }
    }
    // the best visited child, and its rows on their way before init-Q is
    // known: when the descent goes on, it goes into that child unless an
    // unvisited (unexpanded) lane wins
    vis_best = warp_best(vis_best);
    const int spec_c = vis_best.act >= 0 ? lane_value(row.c, vis_best.act) : -1;
    Row<K> next;
    const int nx = spec_c >= 0 ? spec_c : node;
    load_row(next, ci + (size_t)nx * A, prior + (size_t)nx * A, legal + (size_t)nx * A, A,
             lane);
    const unsigned kp = open_a >= 0 ? fkey(open_p) : 0u;
    const unsigned kpmax = __reduce_max_sync(kFull, kp);
    const unsigned open_min = __reduce_min_sync(
        kFull, (open_a >= 0 && kp == kpmax) ? (unsigned)open_a : kNone);
    const float sq = (float)warp_sum(sum_q);
    const float nv = (float)__reduce_add_sync(kFull, num_visited);
    float init_q;
    if (p.init_q_average) init_q = nv > 0.0f ? sq / fmaxf(nv, 1.0f) : 1.0f;
    else init_q = (sq - 1.0f) / (nv + 1.0f);
    Best best = vis_best;
    if (open_min != kNone) {
      const int oa = (int)open_min;
      const float opr = __shfl_sync(kFull, open_p, oa & 31);
      const float u = bias * opr * root_sim / (1.0f + 0.0f);  // no visits
      const Best open{u + init_q, opr, oa};
      if (better(open, best)) best = open;
    }
    int act = best.act;
    if (act < 0) {  // no legal action: every score is NEG_INF
      float none[K];
#pragma unroll
      for (int k = 0; k < K; ++k) none[k] = kNegInf;
      act = argmax_tiebreak(none, row.pr, A, lane);
    }
    const int child = lane_value(row.c, act);
    if (child < 0) {
      sel_parent = node; sel_action = act; sel_leaf = -1; sel_new = true;
      done = true;
    } else if (!s_exp[child]) {
      sel_parent = node; sel_action = act; sel_leaf = child; sel_new = false;
      if (lane == 0) s_path[child] = 1;
      done = true;
    } else {
      if (child == spec_c) row = next;
      else
        load_row(row, ci + (size_t)child * A, prior + (size_t)child * A,
                 legal + (size_t)child * A, A, lane);
      node = child;
    }
  }
  __syncwarp();

  uint8_t* npath = p.npath + (size_t)b * N;
  for (int n = lane; n < N; n += 32) npath[n] = s_path[n];
  if (lane == 0) {
    p.nparent[b] = sel_parent;
    p.naction[b] = sel_action;
    p.nleaf[b] = sel_leaf;
    p.nnew[b] = sel_new ? 1 : 0;
  }
}

using KernelFn = void (*)(const Args);

// the instantiation for A actions: K = ceil(A / 32) slots, rounded up to
// one of the compiled sizes; nullptr above 12 slots (A > 384)
KernelFn kernel_for(int A) {
  const int k = (A + 31) / 32;
  if (k <= 1) return tree_step_kernel<1>;
  if (k == 2) return tree_step_kernel<2>;
  if (k == 3) return tree_step_kernel<3>;
  if (k == 4) return tree_step_kernel<4>;
  if (k <= 8) return tree_step_kernel<8>;
  if (k <= 12) return tree_step_kernel<12>;
  return nullptr;
}

size_t dynamic_smem(int N, int A) {
  return (size_t)kWarpsPerBlock * warp_smem_floats(N, A) * sizeof(float);
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
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
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
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<blocks, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block of the
// kernel that a launch with A actions and N nodes runs.
extern "C" int tree_step_attributes(int A, int N, int* regs, int* static_smem,
                                    int* dynamic_smem_bytes) {
  const KernelFn kernel = kernel_for(A);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem_bytes = (int)dynamic_smem(N, A);
  return 0;
}
