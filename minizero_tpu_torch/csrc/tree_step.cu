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
// Design. One warp per game, four games per 128-thread block; the A actions
// are strided over the 32 lanes, reductions are warp shuffles, and per-action
// scratch rows live in shared memory (3 * A floats per warp). The tree arrays
// are updated in place; the kernel allocates nothing. In the reward regime the
// tree's value bounds (min and max q over the visited nodes, and their
// count) are fixed after the backup, so they are reduced over the N nodes
// once per step, not once per walk level.
//
// What bounds it. The least work is data-dependent: the rows that the walk
// reads (children_index, prior, legal: 9 bytes per action) for each node on
// each game's path, the leaf inputs (policy, logit, legal: 9 bytes per
// action), the new row it writes, and the [N] node vectors. At Go 9x9,
// N = 17, A = 82, B = 1024, that is a few MB, about a microsecond at
// 3.35 TB/s; reading every [N, A] row of every tree once would be ~18.6 MB,
// ~5.6 us. The arithmetic is a few thousand flops per game. So the bound is
// bytes, and the real limit of this design is latency: each walk step is a
// dependent chain of global loads and shuffle reductions, so a game costs
// (depth x one row round trip). The design keeps every game's walk inside
// one warp (no inter-block traffic, no second pass) and lets 1024 warps in
// flight hide the load latency of each other. The Atari search (N = 51,
// A = 18, B = 256) moves less (~1 MB a step) but has only 256 warps, two per
// SM, and its backup is a serial chain of dependent loads (parent, reward,
// visits, mean per level) as deep as the leaf: there latency is all of it.
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// argmax of score[0..A) with ties to the larger tiebreak, then the lower
// index (the JAX kernel's _argmax_tiebreak: max, then max tiebreak among the
// maxima, then the lowest index whose tiebreak reaches it).
__device__ int argmax_tiebreak(const float* score, const float* tiebreak, int A, int lane) {
  float best = -INFINITY;
  for (int a = lane; a < A; a += 32) best = fmaxf(best, score[a]);
  best = warp_max(best);
  float best_tb = -INFINITY;
  for (int a = lane; a < A; a += 32) {
    const float tb = score[a] >= best ? tiebreak[a] : kNegInf;
    best_tb = fmaxf(best_tb, tb);
  }
  best_tb = warp_max(best_tb);
  int idx = A;
  for (int a = lane; a < A; a += 32) {
    const float tb = score[a] >= best ? tiebreak[a] : kNegInf;
    if (tb >= best_tb) idx = min(idx, a);
  }
  return warp_min(idx);
}

// lowest index of the maximum of v[0..A)
__device__ int first_argmax(const float* v, int A, int lane) {
  float best = -INFINITY;
  for (int a = lane; a < A; a += 32) best = fmaxf(best, v[a]);
  best = warp_max(best);
  int idx = A;
  for (int a = lane; a < A; a += 32)
    if (v[a] >= best) idx = min(idx, a);
  return warp_min(idx);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tree_step_kernel(const Args p) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= p.B) return;  // whole warp: b is uniform across its lanes

  const int N = p.N, A = p.A, s = p.s;
  const bool en = p.phase > 0;
  float* row_a = smem + (size_t)warp * 3 * A;  // scratch rows of this warp
  float* row_b = row_a + A;
  float* row_c = row_b + A;

  float* vis = p.visits + (size_t)b * N;
  float* mean = p.mean + (size_t)b * N;
  float* value = p.value + (size_t)b * N;
  float* reward = p.reward + (size_t)b * N;
  uint8_t* expanded = p.expanded + (size_t)b * N;
  uint8_t* terminal = p.terminal + (size_t)b * N;
  int* to_play = p.to_play + (size_t)b * N;
  int* ci = p.ci + (size_t)b * N * A;
  float* prior = p.prior + (size_t)b * N * A;
  float* logit = p.logit + (size_t)b * N * A;
  uint8_t* legal = p.legal + (size_t)b * N * A;
  uint8_t* gactive = p.gactive + (size_t)b * A;
  uint8_t* npath = p.npath + (size_t)b * N;

  // ---- 1. expand the new leaf at slot s ----------------------------------
  const bool snew = p.snew[b] != 0;
  if (en && snew) {
    const bool lt = p.lterm[b] != 0;
    for (int a = lane; a < A; a += 32) {
      const bool lg = (p.llegal[(size_t)b * A + a] != 0) && !lt;
      prior[(size_t)s * A + a] = lg ? p.lpolicy[(size_t)b * A + a] : 0.0f;
      logit[(size_t)s * A + a] = lg ? p.llogit[(size_t)b * A + a] : 0.0f;
      legal[(size_t)s * A + a] = lg ? 1 : 0;
    }
    if (lane == 0) {
      const int sp = p.sparent[b], sa = p.saction[b];
      expanded[s] = lt ? 0 : 1;
      terminal[s] = lt ? 1 : 0;
      p.parent[(size_t)b * N + s] = sp;
      p.afp[(size_t)b * N + s] = sa;
      to_play[s] = p.lturn[b];
      value[s] = p.lvalue[b];
      if (p.use_rewards) reward[s] = p.lreward[b];
      p.num_nodes[b] = max(p.num_nodes[b], s + 1);
      if (sp >= 0 && sp < N && sa >= 0 && sa < A) ci[(size_t)sp * A + sa] = s;
    }
  }

  // ---- 2. back up ------------------------------------------------------------
  const bool one_shot = !p.reward_regime;
  if (en) {
    const int leaf = snew ? s : p.sleaf[b];
    float v = 0.0f;
    if (snew) v = p.lvalue[b];
    else if (leaf >= 0) v = value[leaf];
    if (one_shot) {
      // every path node receives the same value: one update per node
      for (int n = lane; n < N; n += 32) {
        if (p.spath[(size_t)b * N + n] != 0 || n == leaf) {
          const float c = vis[n] + 1.0f;
          vis[n] = c;
          mean[n] = mean[n] + (v - mean[n]) / fmaxf(c, 1.0f);
        }
      }
    } else if (lane == 0) {
      // leaf -> root along the parent pointers (this step's expansion
      // included), discounting through each node's reward; a path has at
      // most N nodes
      const int* par = p.parent + (size_t)b * N;
      float u = v;
      int cur = leaf;
      for (int it = 0; it < N && cur >= 0; ++it) {
        const float c = vis[cur] + 1.0f;
        vis[cur] = c;
        mean[cur] = mean[cur] + (u - mean[cur]) / fmaxf(c, 1.0f);
        u = reward[cur] + p.discount * u;
        cur = par[cur];
      }
    }
  }
  for (int n = lane; n < N; n += 32) npath[n] = 0;
  __syncwarp();

  // per-node raw q and, with value_rescale, the tree's value bounds over the
  // visited nodes (mcts.cpp:40-53, 219-228); fixed for the rest of the step
  const bool use_qnode = p.reward_regime;
  auto qnode = [&](int n) -> float {
    return use_qnode ? reward[n] + p.discount * mean[n] : mean[n];
  };
  float q_lo = 0.0f, q_hi = 0.0f;
  bool q_enough = false;
  if (p.value_rescale) {
    float lo = 3.4e38f, hi = kNegInf;
    int visited = 0;
    for (int n = lane; n < N; n += 32) {
      if (vis[n] > 0.0f) {
        const float q = qnode(n);
        lo = fminf(lo, q);
        hi = fmaxf(hi, q);
        visited += 1;
      }
    }
    q_lo = warp_min(lo);
    q_hi = warp_max(hi);
    q_enough = warp_sum(visited) >= 2;
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
  const bool flip_root = p.flip && to_play[0] == 2;
  int first_action = -1;
  if (p.use_gumbel) {
    const float budget = p.gbudget[b];
    float max_count = -INFINITY;
    bool reached = true;
    for (int a = lane; a < A; a += 32) {
      const int c = ci[a];
      const float cv = c >= 0 ? vis[c] : 0.0f;
      row_a[a] = cv;
      max_count = fmaxf(max_count, cv);
      if (gactive[a] && !(cv >= budget)) reached = false;
    }
    max_count = warp_max(max_count);
    const bool all_reached = __all_sync(kFull, reached);
    const float sigma = (p.sigma_visit_c + max_count) * p.sigma_scale_c;
    for (int a = lane; a < A; a += 32) {
      const int c = ci[a];
      const float cv = row_a[a];
      const float q_vis = (c >= 0 && cv > 0.0f) ? norm_q(qnode(c), flip_root) : 0.0f;
      float score = logit[a] + sigma * q_vis;
      if (!(legal[a] && cv > 0.0f)) score = kNegInf;
      row_b[a] = gactive[a] ? score : kNegInf;
    }
    const int m = p.gm[b];
    const float next_budget =
        floorf((float)p.num_sims / (p.log2_m0 * fmaxf((float)m / 2.0f, 1.0f)));
    const bool do_halve = all_reached && next_budget > 0.0f && m > 2 && en;
    if (do_halve) {  // uniform across the warp
      const int new_m = m / 2;
      __syncwarp();
      for (int a = lane; a < A; a += 32) {
        const float ma = row_b[a];
        int rank = 0;
        for (int j = 0; j < A; ++j) {
          const float mj = row_b[j];
          rank += (mj > ma) || (mj == ma && j < a);
        }
        const bool keep = gactive[a] && rank < new_m;
        row_c[a] = keep ? ma : kNegInf;
        gactive[a] = keep ? 1 : 0;
      }
      __syncwarp();
      const int best = first_argmax(row_c, A, lane);
      if (lane == 0) {
        p.gm[b] = new_m;
        p.gbudget[b] = row_a[best] + next_budget;
      }
    }
    __syncwarp();
    // root step: fewest visits among the active actions, ties -> logit
    for (int a = lane; a < A; a += 32) row_b[a] = gactive[a] ? -row_a[a] : kNegInf;
    __syncwarp();
    first_action = argmax_tiebreak(row_b, logit, A, lane);
    __syncwarp();
  }

  // ---- 5b. PUCT descent ---------------------------------------------------
  int sel_parent = 0, sel_action = 0, sel_leaf = -1;
  bool sel_new = false, done = false;
  int node = 0;
  if (first_action >= 0) {
    const int child = ci[first_action];
    sel_action = first_action;
    if (lane == 0) npath[0] = 1;
    if (child < 0) {
      sel_new = true;
      done = true;
    } else if (!expanded[child]) {
      sel_leaf = child;
      if (lane == 0) npath[child] = 1;
      done = true;
    } else {
      node = child;
    }
  }
  for (int it = 0; it < N && !done; ++it) {  // `done` is uniform
    const bool flip_node = p.flip && to_play[node] == 2;
    const int* ci_row = ci + (size_t)node * A;
    const float* prior_row = prior + (size_t)node * A;
    const uint8_t* legal_row = legal + (size_t)node * A;
    double sum_q = 0.0;
    int num_visited = 0;
    for (int a = lane; a < A; a += 32) {
      const int c = ci_row[a];
      const float cv = c >= 0 ? vis[c] : 0.0f;
      const float q = (c >= 0 && cv > 0.0f) ? norm_q(qnode(c), flip_node) : 0.0f;
      row_a[a] = cv;
      row_b[a] = q;
      if (c >= 0 && cv > 0.0f) {
        sum_q += (double)q;
        num_visited += 1;
      }
    }
    const float sq = (float)warp_sum(sum_q);
    const float nv = (float)warp_sum(num_visited);
    float init_q;
    if (p.init_q_average) init_q = nv > 0.0f ? sq / fmaxf(nv, 1.0f) : 1.0f;
    else init_q = (sq - 1.0f) / (nv + 1.0f);
    const float total_sim = vis[node] - 1.0f;
    const float bias = p.puct_init + logf((1.0f + total_sim + p.puct_base) / p.puct_base);
    const float root_sim = sqrtf(fmaxf(total_sim, 0.0f));
    for (int a = lane; a < A; a += 32) {
      const float cv = row_a[a];
      const bool visited = ci_row[a] >= 0 && cv > 0.0f;
      const float u = bias * prior_row[a] * root_sim / (1.0f + cv);
      const float score = u + (visited ? row_b[a] : init_q);
      row_c[a] = legal_row[a] ? score : kNegInf;
    }
    __syncwarp();
    const int act = argmax_tiebreak(row_c, prior_row, A, lane);
    const int child = ci_row[act];
    if (lane == 0) npath[node] = 1;
    if (child < 0) {
      sel_parent = node; sel_action = act; sel_leaf = -1; sel_new = true;
      done = true;
    } else if (!expanded[child]) {
      sel_parent = node; sel_action = act; sel_leaf = child; sel_new = false;
      if (lane == 0) npath[child] = 1;
      done = true;
    } else {
      node = child;
    }
    __syncwarp();
  }

  if (lane == 0) {
    p.nparent[b] = sel_parent;
    p.naction[b] = sel_action;
    p.nleaf[b] = sel_leaf;
    p.nnew[b] = sel_new ? 1 : 0;
  }
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

  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = (size_t)kWarpsPerBlock * 3 * A * sizeof(float);
  tree_step_kernel<<<blocks, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
