// Exact host-side covisibility graph + K1/K2 retrieval.
//
// The port's copy of the JAX package's graph: keyframes are registered with
// the map points they observe, edges weigh the observations two keyframes
// share (kept once they reach `edge_threshold`), and a query walks seed
// points -> their top-K1 observing keyframes -> each one's top covisibility
// neighbours -> the global top-K2 by edge weight. The device keeps a top-C
// approximation of this graph for the tracker (slam/state.py); this exact,
// unbounded one serves host-side retrieval and offline analysis. It needs
// no image library, so it builds on its own.
//
// C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Graph {
  // point id -> observing keyframes
  std::unordered_map<int64_t, std::vector<int64_t>> point_obs;
  // keyframe -> (neighbour keyframe -> shared-observation weight)
  std::unordered_map<int64_t, std::unordered_map<int64_t, int64_t>> edges;
  // keyframe -> observed points
  std::unordered_map<int64_t, std::vector<int64_t>> kf_points;
  int64_t edge_threshold = 50;
};

}  // namespace

extern "C" {

void* covis_create(long edge_threshold) {
  Graph* g = new Graph();
  g->edge_threshold = edge_threshold;
  return g;
}

void covis_destroy(void* h) { delete (Graph*)h; }

// Register a keyframe with the map points it observes. Updates shared-count
// edges against every keyframe already observing those points.
void covis_add_keyframe(void* h, long kf, const long* mpids, long n) {
  Graph* g = (Graph*)h;
  std::unordered_map<int64_t, int64_t> shared;
  auto& own = g->kf_points[kf];
  own.reserve(own.size() + n);
  for (long i = 0; i < n; ++i) {
    int64_t p = mpids[i];
    if (p < 0) continue;
    own.push_back(p);
    auto& obs = g->point_obs[p];
    for (int64_t other : obs)
      if (other != kf) shared[other]++;
    obs.push_back(kf);
  }
  auto& mine = g->edges[kf];
  for (auto& [other, w] : shared) {
    if (w >= g->edge_threshold) {
      mine[other] += w;          // accumulate shared counts
      g->edges[other][kf] += w;
    }
  }
}

// K1/K2 retrieval: seed mpids -> top-K1 observer
// keyframes -> top-`top_n` covisibility neighbours of each -> global top-K2
// by edge weight -> union. Writes up to max_out keyframe ids; returns count.
long covis_query(void* h, const long* seed_mpids, long n_seeds, long k1,
                 long k2, long top_n, long* out_kfs, long max_out) {
  Graph* g = (Graph*)h;
  std::unordered_map<int64_t, int64_t> hist;
  for (long i = 0; i < n_seeds; ++i) {
    int64_t p = seed_mpids[i];
    if (p < 0) continue;
    auto it = g->point_obs.find(p);
    if (it == g->point_obs.end()) continue;
    for (int64_t kf : it->second) hist[kf]++;
  }
  std::vector<std::pair<int64_t, int64_t>> obs(hist.begin(), hist.end());
  std::sort(obs.begin(), obs.end(),
            [](auto& a, auto& b) { return a.second > b.second; });
  if ((long)obs.size() > k1) obs.resize(k1);

  std::vector<std::pair<int64_t, int64_t>> cand;  // (weight, kf)
  for (auto& [kf, cnt] : obs) {
    auto it = g->edges.find(kf);
    if (it == g->edges.end()) continue;
    std::vector<std::pair<int64_t, int64_t>> nb(it->second.begin(),
                                                it->second.end());
    std::sort(nb.begin(), nb.end(),
              [](auto& a, auto& b) { return a.second > b.second; });
    if ((long)nb.size() > top_n) nb.resize(top_n);
    for (auto& [other, w] : nb) cand.push_back({w, other});
  }
  std::sort(cand.begin(), cand.end(),
            [](auto& a, auto& b) { return a.first > b.first; });

  std::unordered_set<int64_t> uni;
  long cnt = 0;
  for (auto& [kf, _] : obs) {
    if (cnt >= max_out) break;
    if (uni.insert(kf).second) out_kfs[cnt++] = kf;
  }
  long taken = 0;
  for (auto& [w, kf] : cand) {
    if (cnt >= max_out || taken >= k2) break;
    if (uni.insert(kf).second) {
      out_kfs[cnt++] = kf;
      ++taken;
    }
  }
  return cnt;
}

// Unseen-point extraction: union of points of the given keyframes minus an
// exclusion set, up to max_out.
long covis_points_of(void* h, const long* kfs, long n_kfs,
                     const long* exclude, long n_excl, long* out_mpids,
                     long max_out) {
  Graph* g = (Graph*)h;
  std::unordered_set<int64_t> excl(exclude, exclude + n_excl);
  std::unordered_set<int64_t> seen;
  long cnt = 0;
  for (long i = 0; i < n_kfs && cnt < max_out; ++i) {
    auto it = g->kf_points.find(kfs[i]);
    if (it == g->kf_points.end()) continue;
    for (int64_t p : it->second) {
      if (cnt >= max_out) break;
      if (excl.count(p) || !seen.insert(p).second) continue;
      out_mpids[cnt++] = p;
    }
  }
  return cnt;
}

long covis_num_edges(void* h) {
  Graph* g = (Graph*)h;
  long n = 0;
  for (auto& [kf, nb] : g->edges) n += (long)nb.size();
  return n / 2;
}

}  // extern "C"
