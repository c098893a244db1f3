// seki_gen — builds the killallgo 7x7 seki pattern table.
//
// Counterpart of the reference's table generator
// (minizero/environment/killallgo/killallgo_seki_7x7.cpp:312-375), written
// from scratch on uint64 bitboards: enumerate all connected inner shapes of
// size [min,max], surround each with a white ring and an outer black wall,
// pick 2 or 3 shape cells as shared liberties ("eyes"), and run an AND-OR
// proof search asking whether NEITHER side can change the local status
// (white cannot kill the inner black block, black cannot capture the ring)
// — with and without attacker passes. Patterns whose proof depended on a
// superko prune are excluded instead of carrying the reference's GHI
// strings: at runtime that is strictly conservative (fewer, never wrong,
// seki adjudications).
//
// Usage: seki_gen <min_size> <max_size> <out_path>
// Output: one "blackhex eyeshex" pair per line (area-relative absolute
// 49-bit masks), the lookup keys of Seki7x7Table::lookup
// (killallgo_seki_7x7.cpp:26-35).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <set>
#include <string>
#include <utility>
#include <vector>

typedef uint64_t u64;
static const int N = 7, NN = 49;
static const u64 FULL = ((u64)1 << NN) - 1;
static const int BLACK = 1, WHITE = 2;

static u64 NBR4[NN], NBR8[NN];

static void init_masks() {
    for (int r = 0; r < N; ++r)
        for (int c = 0; c < N; ++c) {
            int i = r * N + c;
            u64 m4 = 0, m8 = 0;
            for (int dr = -1; dr <= 1; ++dr)
                for (int dc = -1; dc <= 1; ++dc) {
                    if (!dr && !dc) continue;
                    int rr = r + dr, cc = c + dc;
                    if (rr < 0 || rr >= N || cc < 0 || cc >= N) continue;
                    u64 bit = (u64)1 << (rr * N + cc);
                    m8 |= bit;
                    if (dr == 0 || dc == 0) m4 |= bit;
                }
            NBR4[i] = m4;
            NBR8[i] = m8;
        }
}

static inline u64 dilate4(u64 b) {
    u64 r = b;
    while (b) {
        int i = __builtin_ctzll(b);
        b &= b - 1;
        r |= NBR4[i];
    }
    return r;
}

static inline u64 flood(u64 seed, u64 allowed) {
    u64 b = seed & allowed;
    for (;;) {
        u64 g = dilate4(b) & allowed;
        if (g == b) return b;
        b = g;
    }
}

struct Pos {
    u64 stone[3];  // [1]=black, [2]=white
    int pass_count;
    u64 occ() const { return stone[1] | stone[2]; }
};

// place a stone, remove captured opponent blocks; returns false on suicide
static bool play(Pos& p, int cell, int player) {
    u64 bit = (u64)1 << cell;
    int opp = 3 - player;
    p.stone[player] |= bit;
    u64 dead = 0;
    u64 cand = NBR4[cell] & p.stone[opp];
    while (cand) {
        int i = __builtin_ctzll(cand);
        u64 blk = flood((u64)1 << i, p.stone[opp]);
        cand &= ~blk;
        if (!(dilate4(blk) & ~p.occ() & FULL)) dead |= blk;
    }
    p.stone[opp] &= ~dead;
    u64 own = flood(bit, p.stone[player]);
    if (!(dilate4(own) & ~p.occ() & FULL)) {  // suicide
        p.stone[player] &= ~bit;
        p.stone[opp] |= dead;
        return false;
    }
    p.pass_count = 0;
    return true;
}

// Benson pass-alive points of `player`: stones of unconditionally alive
// blocks plus their kept enclosing regions (mirrors the env's matmul
// fixpoint, minizero_tpu/envs/killallgo.py::_benson_bitboard).
static u64 benson(const Pos& p, int player) {
    u64 mine = p.stone[player];
    if (!mine) return 0;
    u64 empty = ~p.occ() & FULL;
    std::vector<u64> blocks, regions;
    u64 rest = mine;
    while (rest) {
        u64 b = flood(rest & (~rest + 1), mine);
        blocks.push_back(b);
        rest &= ~b;
    }
    u64 nonp = FULL & ~mine;
    rest = nonp;
    while (rest) {
        u64 a = flood(rest & (~rest + 1), nonp);
        regions.push_back(a);
        rest &= ~a;
    }
    size_t nb = blocks.size(), na = regions.size();
    std::vector<u64> libs(nb);
    for (size_t b = 0; b < nb; ++b) libs[b] = dilate4(blocks[b]) & empty;
    // vital[a][b]: region a nonempty-in-empties and all its empties are libs of b
    std::vector<std::vector<bool>> vital(na, std::vector<bool>(nb, false));
    std::vector<std::vector<bool>> adj(na, std::vector<bool>(nb, false));
    for (size_t a = 0; a < na; ++a) {
        u64 ae = regions[a] & empty;
        for (size_t b = 0; b < nb; ++b) {
            adj[a][b] = (dilate4(blocks[b]) & regions[a]) != 0;
            vital[a][b] = ae && !(ae & ~libs[b]);
        }
    }
    std::vector<bool> keep_b(nb, true), keep_a(na, true);
    for (bool changed = true; changed;) {
        changed = false;
        for (size_t b = 0; b < nb; ++b) {
            if (!keep_b[b]) continue;
            int v = 0;
            for (size_t a = 0; a < na; ++a)
                if (keep_a[a] && vital[a][b]) ++v;
            if (v < 2) { keep_b[b] = false; changed = true; }
        }
        for (size_t a = 0; a < na; ++a) {
            if (!keep_a[a]) continue;
            for (size_t b = 0; b < nb; ++b)
                if (adj[a][b] && !keep_b[b]) { keep_a[a] = false; changed = true; break; }
        }
    }
    u64 out = 0;
    for (size_t b = 0; b < nb; ++b)
        if (keep_b[b]) out |= blocks[b];
    for (size_t a = 0; a < na; ++a)
        if (keep_a[a]) out |= regions[a];
    return out;
}

struct Search {
    u64 search_area;
    int attacker;
    int anchor;       // a cell of the original white ring
    bool allow_pass;  // attacker may pass (sequential variant)
    bool ssk_seen;    // a superko prune influenced the proof
    bool aborted;     // node cap hit -> verdict unusable
    long nodes;
    std::vector<std::pair<u64, u64>> hist;  // positional superko stack
    size_t hist_base;                       // reset point after double pass
};

static long NODE_CAP = 300000;  // patterns needing deeper proofs abort -> excluded (conservative)
static const int DEPTH_CAP = 256;  // conservative: deeper proofs abort and
                                   // the pattern is excluded from the table

static inline bool in_hist(const Search& S, u64 b, u64 w) {
    for (size_t i = S.hist_base; i < S.hist.size(); ++i)
        if (S.hist[i].first == b && S.hist[i].second == w) return true;
    return false;
}

// candidate move masks in priority order (reference findSearchPrioritySet):
// capture-threat moves, ring liberty fills, the rest
static void priority_masks(const Pos& p, u64 area, u64 ring_libs, u64 out[3]) {
    u64 caps = 0;
    u64 m = area;
    while (m) {
        int i = __builtin_ctzll(m);
        m &= m - 1;
        u64 cand = NBR4[i] & p.occ();
        while (cand) {
            int j = __builtin_ctzll(cand);
            int pl = (p.stone[1] >> j) & 1 ? 1 : 2;
            u64 blk = flood((u64)1 << j, p.stone[pl]);
            cand &= ~blk;
            u64 libs = dilate4(blk) & ~p.occ() & FULL;
            if (libs && !(libs & (libs - 1))) { caps |= (u64)1 << i; break; }
        }
    }
    out[0] = caps;
    out[1] = ring_libs & area & ~caps;
    out[2] = area & ~caps & ~out[1];
}

// true iff the attacker CANNOT change the local status (AND-OR proof,
// reference enclosedSekiSearch)
static bool attacker_fails(Pos p, int turn, bool new_board, Search& S, int depth) {
    if (++S.nodes > NODE_CAP || depth > DEPTH_CAP) { S.aborted = true; return false; }
    if (S.aborted) return false;

    if (benson(p, WHITE)) return S.attacker == BLACK;  // white locally alive
    u64 ring = (p.stone[WHITE] >> S.anchor) & 1 ? flood((u64)1 << S.anchor, p.stone[WHITE]) : 0;
    if (!ring) return S.attacker == WHITE;  // ring captured: black broke it
    if (benson(p, BLACK) & S.search_area) return S.attacker == WHITE;

    u64 ring_libs = dilate4(ring) & ~p.occ() & FULL;
    u64 area = (S.search_area | ring) & ~p.occ();
    if (turn == BLACK) area |= ring_libs;

    bool can_pass = (turn != S.attacker);
    if (S.allow_pass) {
        if (p.pass_count >= 2) {  // double pass: fresh board, history reset
            S.hist_base = S.hist.size();
            p.pass_count = 0;
            new_board = true;
        } else {
            new_board = false;
        }
        if (!new_board && turn == S.attacker) {
            // the attacker may pass only when some move is superko-barred
            u64 m = area;
            bool has_ssk = false;
            while (m && !has_ssk) {
                int i = __builtin_ctzll(m);
                m &= m - 1;
                Pos q = p;
                if (play(q, i, turn) && in_hist(S, q.stone[1], q.stone[2])) has_ssk = true;
            }
            can_pass = has_ssk;
        }
    }

    u64 masks[3];
    priority_masks(p, area, ring_libs, masks);
    for (int k = 0; k < 4; ++k) {
        if (k == 3) {  // pass
            if (!can_pass) continue;
            Pos q = p;
            q.pass_count = p.pass_count + 1;
            bool res = attacker_fails(q, 3 - turn, new_board, S, depth + 1);
            if (S.aborted) return false;
            if (turn == S.attacker) { if (!res) return false; }
            else if (res) return true;
            continue;
        }
        u64 m = masks[k];
        while (m) {
            int i = __builtin_ctzll(m);
            m &= m - 1;
            Pos q = p;
            if (!play(q, i, turn)) continue;
            if (in_hist(S, q.stone[1], q.stone[2])) {
                if (turn == S.attacker) S.ssk_seen = true;
                continue;
            }
            S.hist.push_back({q.stone[1], q.stone[2]});
            bool res = attacker_fails(q, 3 - turn, new_board, S, depth + 1);
            S.hist.pop_back();
            if (S.aborted) return false;
            if (turn == S.attacker) { if (!res) return false; }
            else if (res) return true;
        }
    }
    return turn == S.attacker;
}

static bool run_search(const Pos& root, u64 search_area, int anchor,
                       int attacker, bool allow_pass, bool& ssk, bool& aborted) {
    Search S;
    S.search_area = search_area;
    S.attacker = attacker;
    S.anchor = anchor;
    S.allow_pass = allow_pass;
    S.ssk_seen = false;
    S.aborted = false;
    S.nodes = 0;
    S.hist_base = 0;
    S.hist.push_back({root.stone[1], root.stone[2]});
    bool r = attacker_fails(root, attacker, false, S, 0);
    ssk = ssk || S.ssk_seen;
    aborted = aborted || S.aborted;
    return r;
}

// connected shape enumeration (reference generateBlockCombinations):
// grow every shape by one boundary cell per step, dedup by bitboard
static std::set<u64> enumerate_shapes(int min_size, int max_size) {
    std::set<u64> out, cur;
    for (int i = 0; i < NN; ++i) cur.insert((u64)1 << i);
    for (int size = 1; size <= max_size; ++size) {
        if (size >= min_size)
            for (u64 s : cur) out.insert(s);
        if (size == max_size) break;
        std::set<u64> next;
        for (u64 s : cur) {
            u64 b = dilate4(s) & ~s;
            while (b) {
                int i = __builtin_ctzll(b);
                b &= b - 1;
                next.insert(s | ((u64)1 << i));
            }
        }
        cur.swap(next);
    }
    return out;
}

int main(int argc, char** argv) {
    if (argc < 4) {
        std::fprintf(stderr, "usage: seki_gen <min_size> <max_size> <out_path> [node_cap]\n");
        return 2;
    }
    init_masks();
    int min_size = std::atoi(argv[1]), max_size = std::atoi(argv[2]);
    if (argc > 4) NODE_CAP = std::atol(argv[4]);
    std::set<u64> shapes = enumerate_shapes(min_size, max_size);
    std::set<std::pair<u64, u64>> table;
    long searched = 0, aborted_count = 0;

    for (u64 shape : shapes) {
        // white ring = 8-neighbourhood of the shape; needs to fit the board
        u64 ring = 0;
        u64 m = shape;
        while (m) {
            int i = __builtin_ctzll(m);
            m &= m - 1;
            ring |= NBR8[i];
        }
        ring &= ~shape;
        // pick 2 or 3 shared liberties ("eyes") inside the shape
        std::vector<int> cells;
        for (int i = 0; i < NN; ++i)
            if ((shape >> i) & 1) cells.push_back(i);
        int n = (int)cells.size();
        for (int eyes = 2; eyes <= 3 && eyes < n; ++eyes) {
            std::vector<int> pick(eyes);
            std::vector<bool> sel(n, false);
            std::fill(sel.begin(), sel.begin() + eyes, true);
            do {
                u64 eyebb = 0;
                for (int i = 0; i < n; ++i)
                    if (sel[i]) eyebb |= (u64)1 << cells[i];
                u64 black = shape & ~eyebb;
                if (!black) continue;
                Pos p{};
                p.stone[BLACK] = black;
                p.stone[WHITE] = ring;
                // outer wall: black on every ring liberty outside the shape
                u64 outer = dilate4(ring) & ~shape & ~ring;
                p.stone[BLACK] |= outer;
                p.pass_count = 0;
                // construction must leave every block alive (the reference
                // rejects patterns whose setup captures stones)
                bool ok = true;
                for (int pl = 1; pl <= 2 && ok; ++pl) {
                    u64 rest = p.stone[pl];
                    while (rest) {
                        u64 blk = flood(rest & (~rest + 1), p.stone[pl]);
                        rest &= ~blk;
                        if (!(dilate4(blk) & ~p.occ() & FULL)) { ok = false; break; }
                    }
                }
                if (!ok) continue;
                // inner influence + sparse-area rejection (isEnclosedSeki)
                u64 inner = dilate4(black) & ~p.stone[WHITE];
                u64 ring_libs = dilate4(ring) & ~p.occ() & FULL;
                if (shape & ~inner & ~ring_libs) continue;
                u64 search_area = inner | ring | ring_libs;
                int anchor = __builtin_ctzll(ring);

                bool ssk = false, ab = false;
                ++searched;
                bool seki = run_search(p, search_area, anchor, WHITE, false, ssk, ab) &&
                            run_search(p, search_area, anchor, BLACK, false, ssk, ab) &&
                            run_search(p, search_area, anchor, WHITE, true, ssk, ab) &&
                            run_search(p, search_area, anchor, BLACK, true, ssk, ab);
                if (ab) { ++aborted_count; continue; }
                if (seki && !ssk) {
                    // lookup key: (black in area, empty in area) with
                    // area = the enclosed shape
                    table.insert({black, eyebb});
                }
            } while (std::prev_permutation(sel.begin(), sel.end()));
        }
    }

    std::FILE* f = std::fopen(argv[3], "w");
    if (!f) { std::perror("fopen"); return 1; }
    for (const auto& kv : table)
        std::fprintf(f, "%llx %llx\n", (unsigned long long)kv.first, (unsigned long long)kv.second);
    std::fclose(f);
    std::fprintf(stderr, "seki_gen: %zu shapes, %ld patterns searched, %zu sekis, %ld aborted\n",
                 shapes.size(), searched, table.size(), aborted_count);
    return 0;
}
