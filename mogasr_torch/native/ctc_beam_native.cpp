// Native batch CTC prefix-beam search (host-side hot loop).
//
// Same algorithm as mogasr.am.ctc.ctc_beam_step (Hannun et al. 2014),
// including iteration order (beams in ranked order, units ascending, new
// prefixes in first-touch order, stable sort) and double-precision
// logaddexp, so results match the Python implementation exactly (tested).
// The per-frame work is O(beam * V_pruned); on long utterances with wide
// beams the Python dict loop dominates host decode time — this is the
// production path, the Python version stays as the readable oracle.
//
// C ABI, loaded via ctypes (mogasr/native/__init__.py); no Python.h.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double NEG_INF = -1e30;

inline double lse(double a, double b) {
  if (a <= NEG_INF / 2) return b;
  if (b <= NEG_INF / 2) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct Beam {
  std::vector<int32_t> prefix;
  double pb;   // ending in blank
  double pnb;  // ending in its last label
  double total() const { return lse(pb, pnb); }
};

struct NewBeams {
  // first-touch ordered map prefix -> index (mirrors Python dict order)
  std::unordered_map<std::string, size_t> index;
  std::vector<Beam> items;

  static std::string key_of(const std::vector<int32_t>& p) {
    return std::string(reinterpret_cast<const char*>(p.data()),
                       p.size() * sizeof(int32_t));
  }

  void add(std::vector<int32_t>&& prefix, double pb, double pnb) {
    std::string k = key_of(prefix);
    auto it = index.find(k);
    if (it == index.end()) {
      index.emplace(std::move(k), items.size());
      items.push_back(Beam{std::move(prefix), pb, pnb});
    } else {
      Beam& b = items[it->second];
      b.pb = lse(b.pb, pb);
      b.pnb = lse(b.pnb, pnb);
    }
  }
};

}  // namespace

extern "C" {

// logp: [T, V] row-major float32 log posteriors (valid frames only).
// Writes the ranked beam: out_seqs [beam_size, max_len] (-1 padded),
// out_lens [beam_size], out_scores [beam_size]; returns #hypotheses.
int32_t ctc_prefix_beam(const float* logp, int64_t T, int64_t V,
                        int32_t beam_size, int32_t blank, double prune_logp,
                        int32_t* out_seqs, int32_t* out_lens,
                        double* out_scores, int32_t max_len) {
  std::vector<Beam> beams;
  beams.push_back(Beam{{}, 0.0, NEG_INF});

  std::vector<int32_t> units;
  units.reserve(V);
  for (int64_t t = 0; t < T; ++t) {
    const float* frame = logp + t * V;
    float fmax = frame[0];
    for (int64_t v = 1; v < V; ++v) fmax = frame[v] > fmax ? frame[v] : fmax;
    units.clear();
    for (int64_t v = 0; v < V; ++v)
      if (frame[v] > fmax + prune_logp) units.push_back((int32_t)v);

    NewBeams nb;
    for (const Beam& beam : beams) {
      double ptot = beam.total();
      for (int32_t u : units) {
        double lp = (double)frame[u];
        if (u == blank) {
          nb.add(std::vector<int32_t>(beam.prefix), ptot + lp, NEG_INF);
          continue;
        }
        int32_t last = beam.prefix.empty() ? -1 : beam.prefix.back();
        if (u == last) {
          // same unit: stay extends p_nb of the SAME prefix; a repeat
          // needs an intervening blank (p_b)
          nb.add(std::vector<int32_t>(beam.prefix), NEG_INF, beam.pnb + lp);
          std::vector<int32_t> ext(beam.prefix);
          ext.push_back(u);
          nb.add(std::move(ext), NEG_INF, beam.pb + lp);
        } else {
          std::vector<int32_t> ext(beam.prefix);
          ext.push_back(u);
          nb.add(std::move(ext), NEG_INF, ptot + lp);
        }
      }
    }
    // rank by total, stable on first-touch order (mirrors Python sorted())
    std::vector<size_t> order(nb.items.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
      return nb.items[a].total() > nb.items[b].total();
    });
    size_t keep = order.size() < (size_t)beam_size ? order.size() : (size_t)beam_size;
    std::vector<Beam> next;
    next.reserve(keep);
    for (size_t i = 0; i < keep; ++i) next.push_back(std::move(nb.items[order[i]]));
    beams.swap(next);
  }

  std::vector<size_t> order(beams.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return beams[a].total() > beams[b].total();
  });
  int32_t n = 0;
  for (size_t i = 0; i < order.size() && n < beam_size; ++i, ++n) {
    const Beam& b = beams[order[i]];
    int32_t len = (int32_t)b.prefix.size();
    if (len > max_len) len = max_len;
    for (int32_t j = 0; j < len; ++j) out_seqs[n * max_len + j] = b.prefix[j];
    for (int32_t j = len; j < max_len; ++j) out_seqs[n * max_len + j] = -1;
    out_lens[n] = len;
    out_scores[n] = b.total();
  }
  return n;
}

}  // extern "C"
