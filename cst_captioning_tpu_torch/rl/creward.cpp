// Consensus-reward scorer: CIDEr-D + smoothed sentence BLEU-4, the port's
// copy of cst_captioning_tpu/native/creward.cpp (same code, same numbers).
//
// Scores B x K sampled captions against per-video reference pools over
// interned token ids with FNV-style 64-bit gram hashes, multi-threaded.
// Reference pools are flattened once at add_video time into hash-sorted
// arrays; each hypothesis row builds its sorted gram lists in per-worker
// buffers and every dot product / clipped match is a two-pointer merge.
//
// Semantics are those of the Python scorer in rl/rewards.py:
//   - CIDEr-D: tf-idf n-gram cosine with hyp counts clipped to the ref's,
//     gaussian length penalty exp(-(lh-lr)^2 / (2*sigma^2)), mean over
//     n=1..4 and refs, x10.
//   - BLEU-4: clipped precision vs max ref counts, +1 smoothing for n>1,
//     brevity penalty vs closest ref length.
// tests/test_torch_train.py holds both paths against the JAX package's.
//
// Tokens are interned word ids built by the Python wrapper from the union
// of reference words and the model vocab, so OOV reference words keep their
// string identity.
//
// Built at first use by rl/native.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread creward.cpp -o libcreward.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int MAX_N = 4;

inline uint64_t hash_gram(const int32_t* toks, int n) {
    // splitmix64-style mixing over up to 4 token ids; low collision odds
    // (~1e-13 for 1M grams) and deterministic across platforms.
    uint64_t h = 0x9e3779b97f4a7c15ull ^ (uint64_t)n;
    for (int i = 0; i < n; ++i) {
        uint64_t x = (uint64_t)(uint32_t)toks[i] + 0x9e3779b97f4a7c15ull;
        x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
        x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
        h ^= (x ^ (x >> 31)) + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    return h;
}

using GramCounts = std::unordered_map<uint64_t, int>;

// n-gram counts of one token sequence, all orders 1..4 (build-time only).
void count_grams(const int32_t* toks, int len, GramCounts out[MAX_N]) {
    for (int n = 1; n <= MAX_N; ++n) {
        GramCounts& m = out[n - 1];
        for (int i = 0; i + n <= len; ++i) {
            ++m[hash_gram(toks + i, n)];
        }
    }
}

// hash-sorted flat (gram -> weight) vector: the merge-join operand
struct FlatVec {
    std::vector<uint64_t> h;
    std::vector<double> w;
};

// hash-sorted flat (gram -> count) vector
struct FlatCounts {
    std::vector<uint64_t> h;
    std::vector<int> c;
};

struct RefVec {
    FlatVec vec[MAX_N];
    double norm[MAX_N] = {0, 0, 0, 0};
    int len = 0;
};

struct VideoStats {
    std::vector<RefVec> cider;            // per reference
    FlatCounts bleu_max[MAX_N];           // elementwise max ref counts
    std::vector<int> ref_lens;
};

struct Ctx {
    double log_ndoc = 1.0;
    double sigma = 6.0;
    std::unordered_map<uint64_t, double> df;
    std::vector<VideoStats> videos;
    int32_t eos_id = 2, pad_id = 0, bos_id = 1;
};

inline double idf(const Ctx& c, uint64_t gram) {
    auto it = c.df.find(gram);
    double d = it == c.df.end() ? 0.0 : it->second;
    return c.log_ndoc - std::log(d > 1.0 ? d : 1.0);
}

// effective hypothesis length: tokens up to (excluding) EOS/PAD, skipping BOS
int effective_row(const int32_t* row, int T, const Ctx& c, int32_t* out) {
    int n = 0;
    for (int t = 0; t < T; ++t) {
        int32_t tok = row[t];
        if (tok == c.eos_id || tok == c.pad_id) break;
        if (tok == c.bos_id) continue;
        out[n++] = tok;
    }
    return n;
}

// one hypothesis's grams of one order: deduped, then hash-sorted, with
// per-gram tf-idf weights. Buffers are reused across rows (no allocation in
// the steady state — capacity grows to the max gram count once).
struct HypOrder {
    std::vector<uint64_t> h;
    std::vector<int> c;
    std::vector<double> w;     // tf * idf, filled after sorting
    std::vector<int> order;    // sort permutation scratch
    std::vector<uint64_t> h2;  // permutation-apply scratch
    std::vector<int> c2;

    void build(const int32_t* toks, int len, int n) {
        h.clear();
        c.clear();
        for (int i = 0; i + n <= len; ++i) {
            uint64_t hh = hash_gram(toks + i, n);
            // linear dedup: caption-order gram counts are tiny (<= ~30)
            size_t j = 0, sz = h.size();
            for (; j < sz; ++j) {
                if (h[j] == hh) {
                    ++c[j];
                    break;
                }
            }
            if (j == sz) {
                h.push_back(hh);
                c.push_back(1);
            }
        }
        // sort (h, c) by hash via a permutation (arrays are tiny)
        size_t sz = h.size();
        order.resize(sz);
        for (size_t i = 0; i < sz; ++i) order[i] = (int)i;
        std::sort(order.begin(), order.end(),
                  [&](int a, int b) { return h[a] < h[b]; });
        w.resize(sz);
        h2.resize(sz);
        c2.resize(sz);
        for (size_t i = 0; i < sz; ++i) {
            h2[i] = h[order[i]];
            c2[i] = c[order[i]];
        }
        h.swap(h2);
        c.swap(c2);
    }

    double weigh(const Ctx& ctx) {   // fills w, returns l2 norm
        double norm = 0.0;
        for (size_t i = 0; i < h.size(); ++i) {
            double ww = (double)c[i] * idf(ctx, h[i]);
            w[i] = ww;
            norm += ww * ww;
        }
        return std::sqrt(norm);
    }
};

double cider_d_one(const Ctx& c, const VideoStats& vs, HypOrder hyp[MAX_N],
                   const double hnorm[MAX_N], int hyp_len) {
    double per_n[MAX_N] = {0, 0, 0, 0};
    for (const RefVec& rv : vs.cider) {
        double pen = std::exp(-((double)(hyp_len - rv.len) * (hyp_len - rv.len)) /
                              (2.0 * c.sigma * c.sigma));
        for (int n = 0; n < MAX_N; ++n) {
            double denom = hnorm[n] * rv.norm[n];
            if (denom <= 0) continue;
            const HypOrder& ho = hyp[n];
            const FlatVec& fv = rv.vec[n];
            double dot = 0.0;
            size_t i = 0, j = 0, hs = ho.h.size(), rs = fv.h.size();
            while (i < hs && j < rs) {          // sorted merge-join
                uint64_t a = ho.h[i], b = fv.h[j];
                if (a == b) {
                    double hw = ho.w[i], rw = fv.w[j];
                    dot += (hw < rw ? hw : rw) * rw;
                    ++i;
                    ++j;
                } else if (a < b) {
                    ++i;
                } else {
                    ++j;
                }
            }
            per_n[n] += pen * dot / denom;
        }
    }
    double nref = vs.cider.empty() ? 1.0 : (double)vs.cider.size();
    double mean = 0.0;
    for (int n = 0; n < MAX_N; ++n) mean += per_n[n] / nref;
    return mean / MAX_N * 10.0;
}

double bleu4_one(const Ctx&, const VideoStats& vs, const HypOrder hyp[MAX_N],
                 int hyp_len) {
    if (hyp_len == 0 || vs.ref_lens.empty()) return 0.0;
    // closest ref length (ties -> smaller)
    int best = vs.ref_lens[0];
    for (int rl : vs.ref_lens) {
        int da = std::abs(rl - hyp_len), db = std::abs(best - hyp_len);
        if (da < db || (da == db && rl < best)) best = rl;
    }
    double bp = hyp_len >= best ? 1.0 : std::exp(1.0 - (double)best / hyp_len);
    double log_p = 0.0, score = 0.0;
    for (int n = 1; n <= MAX_N; ++n) {
        long matched = 0, total = 0;
        const HypOrder& ho = hyp[n - 1];
        const FlatCounts& maxc = vs.bleu_max[n - 1];
        size_t i = 0, j = 0, hs = ho.h.size(), rs = maxc.h.size();
        for (size_t k = 0; k < hs; ++k) total += ho.c[k];
        while (i < hs && j < rs) {              // sorted merge-join
            uint64_t a = ho.h[i], b = maxc.h[j];
            if (a == b) {
                matched += ho.c[i] < maxc.c[j] ? ho.c[i] : maxc.c[j];
                ++i;
                ++j;
            } else if (a < b) {
                ++i;
            } else {
                ++j;
            }
        }
        double p;
        if (n == 1) p = total ? (double)matched / total : 0.0;
        else p = total ? (matched + 1.0) / (total + 1.0) : 0.0;
        if (p == 0.0) return 0.0;
        log_p += std::log(p);
        score = bp * std::exp(log_p / n);
    }
    return score;
}

// flatten an unordered map into a hash-sorted FlatVec/FlatCounts
void flatten_vec(const std::unordered_map<uint64_t, double>& m, FlatVec& out) {
    out.h.reserve(m.size());
    for (const auto& kv : m) out.h.push_back(kv.first);
    std::sort(out.h.begin(), out.h.end());
    out.w.resize(out.h.size());
    for (size_t i = 0; i < out.h.size(); ++i) out.w[i] = m.at(out.h[i]);
}

void flatten_counts(const GramCounts& m, FlatCounts& out) {
    out.h.reserve(m.size());
    for (const auto& kv : m) out.h.push_back(kv.first);
    std::sort(out.h.begin(), out.h.end());
    out.c.resize(out.h.size());
    for (size_t i = 0; i < out.h.size(); ++i) out.c[i] = m.at(out.h[i]);
}

}  // namespace

extern "C" {

void* crw_create(double log_ndoc, double sigma, int32_t pad_id, int32_t bos_id,
                 int32_t eos_id) {
    Ctx* c = new Ctx();
    c->log_ndoc = log_ndoc;
    c->sigma = sigma;
    c->pad_id = pad_id;
    c->bos_id = bos_id;
    c->eos_id = eos_id;
    return c;
}

void crw_free(void* h) { delete (Ctx*)h; }

// df entries: n_grams grams; gram i occupies gram_lens[i] ids in `tokens`
// (concatenated), with document frequency counts[i].
void crw_set_df(void* h, const int32_t* tokens, const int32_t* gram_lens,
                const double* counts, int64_t n_grams) {
    Ctx* c = (Ctx*)h;
    c->df.reserve((size_t)n_grams * 2);
    int64_t off = 0;
    for (int64_t i = 0; i < n_grams; ++i) {
        int n = gram_lens[i];
        c->df[hash_gram(tokens + off, n)] = counts[i];
        off += n;
    }
}

// add one video's reference pool: ref i occupies ref_lens[i] ids in `tokens`.
// Returns the video index used by crw_score.
int32_t crw_add_video(void* h, const int32_t* tokens, const int32_t* ref_lens,
                      int32_t n_refs) {
    Ctx* c = (Ctx*)h;
    c->videos.emplace_back();
    VideoStats& vs = c->videos.back();
    GramCounts bleu_max[MAX_N];
    int64_t off = 0;
    for (int32_t r = 0; r < n_refs; ++r) {
        int len = ref_lens[r];
        GramCounts counts[MAX_N];
        count_grams(tokens + off, len, counts);
        // CIDEr vectors (built in a map, flattened hash-sorted for the
        // per-row merge-joins)
        vs.cider.emplace_back();
        RefVec& rv = vs.cider.back();
        rv.len = len;
        for (int n = 0; n < MAX_N; ++n) {
            std::unordered_map<uint64_t, double> vec;
            vec.reserve(counts[n].size() * 2);
            for (const auto& kv : counts[n]) {
                double w = (double)kv.second * idf(*c, kv.first);
                vec[kv.first] = w;
                rv.norm[n] += w * w;
            }
            rv.norm[n] = std::sqrt(rv.norm[n]);
            flatten_vec(vec, rv.vec[n]);
        }
        // BLEU max counts
        for (int n = 0; n < MAX_N; ++n)
            for (const auto& kv : counts[n]) {
                int& slot = bleu_max[n][kv.first];
                if (kv.second > slot) slot = kv.second;
            }
        vs.ref_lens.push_back(len);
        off += len;
    }
    for (int n = 0; n < MAX_N; ++n) flatten_counts(bleu_max[n], vs.bleu_max[n]);
    return (int32_t)(c->videos.size() - 1);
}

// score n_rows hypotheses (rows of length T, interned ids, EOS-terminated)
// against videos[video_idx[i]]; out[i] = cw*CIDErD + bw*BLEU4*10.
void crw_score(void* h, const int32_t* video_idx, const int32_t* rows,
               int64_t n_rows, int32_t T, double cider_w, double bleu_w,
               int32_t n_threads, float* out) {
    Ctx* c = (Ctx*)h;
    if (n_threads < 1) n_threads = 1;
    auto worker = [&](int64_t lo, int64_t hi) {
        std::vector<int32_t> buf(T);
        HypOrder hyp[MAX_N];   // reused across rows: no steady-state mallocs
        for (int64_t i = lo; i < hi; ++i) {
            const VideoStats& vs = c->videos[video_idx[i]];
            int len = effective_row(rows + i * T, T, *c, buf.data());
            double hnorm[MAX_N] = {0, 0, 0, 0};
            for (int n = 0; n < MAX_N; ++n) {
                hyp[n].build(buf.data(), len, n + 1);
                if (cider_w != 0.0) hnorm[n] = hyp[n].weigh(*c);  // df lookups
            }
            double r = 0.0;
            if (cider_w != 0.0)
                r += cider_w * cider_d_one(*c, vs, hyp, hnorm, len);
            if (bleu_w != 0.0)
                r += bleu_w * bleu4_one(*c, vs, hyp, len) * 10.0;
            // scores are computed in double but cross the ABI as float32:
            // callers comparing against a float64 oracle (the Python
            // CiderD scorer) must budget ~1e-7 relative tolerance for this
            // narrowing — pinned by the parity tests in
            // tests/test_metrics_cider.py
            out[i] = (float)r;
        }
    };
    if (n_threads == 1 || n_rows < 64) {
        worker(0, n_rows);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = lo + chunk < n_rows ? lo + chunk : n_rows;
        if (lo >= hi) break;
        threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
