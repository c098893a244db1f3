// Native record codec — the host-side hot path of the data plane (a copy of
// minizero_tpu/native/codec.cpp for the PyTorch port).
//
// Counterpart of the reference's C++ record machinery
// (minizero/environment/base/base_env.h:207-319 record serialization and
// minizero/learner/data_loader.cpp:99-200 string parsing + batch assembly):
// the device produces per-move arrays; this library turns a whole game's
// arrays into the SGF-like record line in one call, and parses record lines
// back into arrays, so the Python loop never touches per-move strings when
// writing the 2000-games-per-iteration stream.
//
// Built at first use by minizero_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC codec.cpp -o ../_build/libmzcodec-<hash>.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// append with bounds check; returns new offset or -1 on overflow
inline int append(char* out, int cap, int off, const char* s, int len)
{
    if (off < 0 || off + len >= cap) { return -1; }
    std::memcpy(out + off, s, len);
    return off + len;
}

inline int append_str(char* out, int cap, int off, const char* s)
{
    return append(out, cap, off, s, static_cast<int>(std::strlen(s)));
}

// shortest %g-style float
inline int append_float(char* out, int cap, int off, float v)
{
    char buf[48];
    int n = std::snprintf(buf, sizeof(buf), "%g", static_cast<double>(v));
    return append(out, cap, off, buf, n);
}

inline int append_int(char* out, int cap, int off, long v)
{
    char buf[32];
    int n = std::snprintf(buf, sizeof(buf), "%ld", v);
    return append(out, cap, off, buf, n);
}

} // namespace

extern "C" {

// Serialize one game's move stream:
//   ;B[a]P[i:w,i:w,...]V[v]R[r];W[a]...
// players: 1 -> B, 2 -> W. policy is [length, action_size] row-major; only
// entries > threshold are emitted (sparse, like the reference's
// getSearchDistributionString, mcts.cpp:126-137).
// Returns the number of bytes written, or -1 if out_cap is too small.
int mz_serialize_moves(
    const int32_t* actions,
    const int8_t* players,
    const float* policy,
    const float* values,
    const float* rewards,
    int length,
    int action_size,
    float threshold,
    char* out,
    int out_cap)
{
    int off = 0;
    char head[8];
    for (int i = 0; i < length; ++i) {
        head[0] = ';';
        head[1] = (players[i] == 2 ? 'W' : 'B');
        head[2] = '[';
        off = append(out, out_cap, off, head, 3);
        off = append_int(out, out_cap, off, actions[i]);
        off = append_str(out, out_cap, off, "]P[");
        const float* row = policy + static_cast<long>(i) * action_size;
        bool first = true;
        for (int a = 0; a < action_size; ++a) {
            if (row[a] <= threshold) { continue; }
            if (!first) { off = append(out, out_cap, off, ",", 1); }
            first = false;
            off = append_int(out, out_cap, off, a);
            off = append(out, out_cap, off, ":", 1);
            off = append_float(out, out_cap, off, row[a]);
        }
        off = append_str(out, out_cap, off, "]V[");
        off = append_float(out, out_cap, off, values[i]);
        off = append_str(out, out_cap, off, "]R[");
        off = append_float(out, out_cap, off, rewards[i]);
        off = append(out, out_cap, off, "]", 1);
        if (off < 0) { return -1; }
    }
    return off;
}

// Parse the move stream of a record line back into arrays. Expects the
// same grammar mz_serialize_moves emits (the zero loop's own records);
// arbitrary reference SGF still goes through the Python fallback parser.
// Returns the number of moves parsed, or -1 on malformed input / overflow.
int mz_parse_moves(
    const char* text,
    int text_len,
    int max_moves,
    int action_size,
    int32_t* actions,
    int8_t* players,
    float* policy, // [max_moves, action_size], caller-zeroed
    float* values,
    float* rewards)
{
    int count = 0;
    const char* p = text;
    const char* end = text + text_len;
    while (p < end) {
        // find ";B[" or ";W["
        while (p + 2 < end && !(p[0] == ';' && (p[1] == 'B' || p[1] == 'W') && p[2] == '[')) { ++p; }
        if (p + 2 >= end) { break; }
        if (count >= max_moves) { return -1; }
        players[count] = (p[1] == 'W' ? 2 : 1);
        p += 3;
        char* next = nullptr;
        long a = std::strtol(p, &next, 10);
        if (next == p || *next != ']') { return -1; }
        actions[count] = static_cast<int32_t>(a);
        p = next + 1;
        float* row = policy + static_cast<long>(count) * action_size;
        if (p + 2 < end && p[0] == 'P' && p[1] == '[') {
            p += 2;
            while (p < end && *p != ']') {
                long idx = std::strtol(p, &next, 10);
                if (next == p || *next != ':') { return -1; }
                p = next + 1;
                float w = std::strtof(p, &next);
                if (next == p) { return -1; }
                p = next;
                if (idx >= 0 && idx < action_size) { row[idx] = w; }
                if (p < end && *p == ',') { ++p; }
            }
            if (p < end) { ++p; } // skip ']'
        }
        if (p + 2 < end && p[0] == 'V' && p[1] == '[') {
            values[count] = std::strtof(p + 2, &next);
            p = (*next == ']' ? next + 1 : next);
        }
        if (p + 2 < end && p[0] == 'R' && p[1] == '[') {
            rewards[count] = std::strtof(p + 2, &next);
            p = (*next == ']' ? next + 1 : next);
        }
        ++count;
    }
    return count;
}

} // extern "C"
