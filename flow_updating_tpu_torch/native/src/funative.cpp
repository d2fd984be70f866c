// funative — the host runtime of flow_updating_tpu_torch.
//
// The port's own copy of the parts of flow_updating_tpu/native/src/
// funative.cpp that it needs, kept identical in what they compute so that
// both packages build the same graphs and route the same networks from
// the same inputs:
//
//  * exact graph generators at 1M+ node scale: Erdos-Renyi G(n, m) with a
//    Hamiltonian backbone (n >= 100,000) and the sequential
//    Barabasi-Albert process (n > 10,000);
//  * the symmetrize/dedup/sort/reverse-permutation graph builder (two
//    million declared pairs and more);
//  * the Benes network router (networks of 2^14 elements and more; the
//    k=160 fat tree's neighbor-sum network is 2^23 wide);
//  * the greedy proper edge coloring of the fast synchronous pairwise
//    mode (graphs of 50,000 directed edges and more).
//
// Plain C ABI for ctypes; built with g++ -O3 -std=c++17 -fPIC -shared on
// first use by flow_updating_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Generators.  All emit directed pairs (u, v); symmetrization happens in
// fu_build_graph.  Return value = number of pairs written, or -1 on error.
// ---------------------------------------------------------------------------

// Erdos-Renyi G(n, m) + a random Hamiltonian backbone for connectivity.
// out_pairs must hold 2 * (m + n) int64 entries.
int64_t fu_gen_erdos_renyi(int64_t n, int64_t m, uint64_t seed,
                           int64_t* out_pairs) {
  if (n < 2 || m < 0) return -1;
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> pick(0, n - 1);
  int64_t k = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t u = pick(rng), v = pick(rng);
    out_pairs[2 * k] = u;
    out_pairs[2 * k + 1] = v;
    ++k;
  }
  std::vector<int64_t> perm(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  std::shuffle(perm.begin(), perm.end(), rng);
  for (int64_t i = 0; i < n; ++i) {
    out_pairs[2 * k] = perm[i];
    out_pairs[2 * k + 1] = perm[(i + 1) % n];
    ++k;
  }
  return k;
}

// Exact sequential Barabasi-Albert: seed clique on (m+1) nodes, then each
// new node attaches to m distinct endpoints sampled from the endpoint
// multiset (preferential attachment).  out_pairs must hold
// 2 * (m*(m+1)/2 + (n-m-1)*m) entries.
int64_t fu_gen_barabasi_albert(int64_t n, int64_t m, uint64_t seed,
                               int64_t* out_pairs) {
  if (m < 1 || n < m + 2) return -1;
  std::mt19937_64 rng(seed);
  std::vector<int64_t> endpoints;
  endpoints.reserve(2 * (size_t)(m * (m + 1) / 2 + (n - m - 1) * m));
  int64_t k = 0;
  for (int64_t i = 0; i <= m; ++i)
    for (int64_t j = i + 1; j <= m; ++j) {
      out_pairs[2 * k] = i;
      out_pairs[2 * k + 1] = j;
      endpoints.push_back(i);
      endpoints.push_back(j);
      ++k;
    }
  std::vector<int64_t> targets(m);
  for (int64_t v = m + 1; v < n; ++v) {
    int64_t got = 0;
    while (got < m) {
      std::uniform_int_distribution<size_t> pick(0, endpoints.size() - 1);
      int64_t t = endpoints[pick(rng)];
      bool dup = false;
      for (int64_t j = 0; j < got; ++j) dup |= (targets[j] == t);
      if (!dup) targets[got++] = t;
    }
    for (int64_t j = 0; j < m; ++j) {
      out_pairs[2 * k] = v;
      out_pairs[2 * k + 1] = targets[j];
      ++k;
      endpoints.push_back(v);
      endpoints.push_back(targets[j]);
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// Graph builder: directed pairs -> symmetrized, deduped, (src,dst)-sorted
// edge list with reverse permutation and out-degrees.  Two-phase: count
// then fill, so the caller can allocate exactly.  Pairs with an endpoint
// outside [0, n) are skipped: the caller range-checks before calling.
// ---------------------------------------------------------------------------

static void symmetrize_sort(int64_t n, int64_t npairs, const int64_t* pairs,
                            std::vector<int64_t>& keys) {
  keys.clear();
  keys.reserve(2 * (size_t)npairs);
  for (int64_t i = 0; i < npairs; ++i) {
    int64_t u = pairs[2 * i], v = pairs[2 * i + 1];
    if (u == v || u < 0 || v < 0 || u >= n || v >= n) continue;
    keys.push_back(u * n + v);
    keys.push_back(v * n + u);
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
}

int64_t fu_build_graph_count(int64_t n, int64_t npairs, const int64_t* pairs) {
  std::vector<int64_t> keys;
  symmetrize_sort(n, npairs, pairs, keys);
  return (int64_t)keys.size();
}

// Fills src, dst (int32, length E), rev (int32, length E), out_deg (int32,
// length n).  E must equal fu_build_graph_count's return.
int64_t fu_build_graph(int64_t n, int64_t npairs, const int64_t* pairs,
                       int32_t* src, int32_t* dst, int32_t* rev,
                       int32_t* out_deg) {
  std::vector<int64_t> keys;
  symmetrize_sort(n, npairs, pairs, keys);
  const int64_t E = (int64_t)keys.size();
  memset(out_deg, 0, sizeof(int32_t) * (size_t)n);
  for (int64_t e = 0; e < E; ++e) {
    int64_t u = keys[e] / n, v = keys[e] % n;
    src[e] = (int32_t)u;
    dst[e] = (int32_t)v;
    out_deg[u]++;
  }
  for (int64_t e = 0; e < E; ++e) {
    int64_t rk = (int64_t)dst[e] * n + src[e];
    rev[e] = (int32_t)(std::lower_bound(keys.begin(), keys.end(), rk) -
                       keys.begin());
  }
  return E;
}

// ---------------------------------------------------------------------------
// Benes network routing: swap masks realizing y = x[perm] as 2*log2(n)-1
// columns of 2x2 switches (the same masks as ops/permute.py's numpy
// recursion: at each level the constraint graph of a block is a union of
// even cycles, walked and 2-colored from its lowest uncolored input).
// out must hold (2*log2(n)-1) * n uint8; returns 0, or -1 on bad input.
// ---------------------------------------------------------------------------

int64_t fu_benes_route(int64_t n, const int64_t* perm, uint8_t* out) {
  if (n < 2 || (n & (n - 1))) return -1;
  int k = 0;
  while ((int64_t(1) << k) < n) ++k;
  {
    std::vector<uint8_t> seen(n, 0);
    for (int64_t i = 0; i < n; ++i) {
      if (perm[i] < 0 || perm[i] >= n || seen[perm[i]]) return -1;
      seen[perm[i]] = 1;
    }
  }
  std::vector<int64_t> cur(perm, perm + n), nxt(n), pinv(n);
  std::vector<int8_t> color(n);
  for (int level = 0; level < k - 1; ++level) {
    const int64_t m = n >> level;
    const int64_t h = m >> 1;
    uint8_t* in_row = out + (int64_t)level * n;
    uint8_t* out_row = out + (int64_t)(2 * k - 2 - level) * n;
    for (int64_t start = 0; start < n; start += m) {
      const int64_t* p = &cur[start];
      for (int64_t o = 0; o < m; ++o) pinv[start + p[o]] = o;
      std::fill(color.begin() + start, color.begin() + start + m, -1);
      int8_t* col = &color[start];
      const int64_t* pv = &pinv[start];
      for (int64_t s = 0; s < m; ++s) {
        if (col[s] != -1) continue;
        int64_t i = s;
        int8_t c = 0;
        while (col[i] == -1) {
          col[i] = c;
          int64_t partner = i ^ h;
          col[partner] = 1 - c;
          i = p[pv[partner] ^ h];
        }
      }
      for (int64_t i = 0; i < h; ++i) {
        uint8_t sw = col[i] == 1;
        in_row[start + i] = sw;
        in_row[start + h + i] = sw;
      }
      for (int64_t o = 0; o < h; ++o) {
        bool top_u = col[p[o]] == 0;
        uint8_t sw = !top_u;
        out_row[start + o] = sw;
        out_row[start + h + o] = sw;
        int64_t s_u = top_u ? p[o] : p[o + h];
        int64_t s_l = top_u ? p[o + h] : p[o];
        nxt[start + o] = s_u & (h - 1);
        nxt[start + h + o] = s_l & (h - 1);
      }
    }
    std::swap(cur, nxt);
  }
  uint8_t* mid = out + (int64_t)(k - 1) * n;
  for (int64_t start = 0; start < n; start += 2) {
    uint8_t sw = cur[start] == 1;
    mid[start] = sw;
    mid[start + 1] = sw;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy proper edge coloring (undirected; both directions share a color).
//
// Host-side prerequisite of the fast synchronous pairwise mode (one color
// class fires per round).  Edges are processed hubs-first (descending
// max-endpoint-degree): each takes the smallest color unused at both
// endpoints, found by merge-scanning the endpoints' sorted used-color
// lists.  Hubs-first keeps the color count near the trivial lower bound
// maxdeg (the numpy matching extractor achieves exactly maxdeg but costs
// O(colors * E) full passes — ~17 s at BA-100k vs well under a second
// here).  Directed inputs must be the framework's sorted symmetric edge
// list; color_out gets the shared color on BOTH directions.  Returns the
// number of colors, or -1 on malformed input.
// ---------------------------------------------------------------------------

int64_t fu_edge_coloring(int64_t n, int64_t E, const int32_t* src,
                         const int32_t* dst, const int32_t* rev,
                         int32_t* color_out) {
  std::vector<int64_t> und;
  und.reserve((size_t)E / 2);
  std::vector<int64_t> deg(n, 0);
  for (int64_t e = 0; e < E; ++e) {
    if (src[e] < 0 || src[e] >= n || dst[e] < 0 || dst[e] >= n) return -1;
    if (rev[e] < 0 || rev[e] >= E) return -1;  // color_out[rev[e]] writes
    deg[src[e]]++;
    if (src[e] < dst[e]) und.push_back(e);
  }
  std::sort(und.begin(), und.end(), [&](int64_t a, int64_t b) {
    int64_t da = std::max(deg[src[a]], deg[dst[a]]);
    int64_t db = std::max(deg[src[b]], deg[dst[b]]);
    if (da != db) return da > db;
    return a < b;
  });
  std::vector<std::vector<int32_t>> used(n);  // sorted per-node color lists
  for (int64_t v = 0; v < n; ++v) used[v].reserve((size_t)deg[v]);
  int32_t num_colors = 0;
  for (int64_t e : und) {
    const std::vector<int32_t>& a = used[src[e]];
    const std::vector<int32_t>& b = used[dst[e]];
    // smallest c >= 0 absent from both sorted lists
    int32_t c = 0;
    size_t i = 0, j = 0;
    while (true) {
      while (i < a.size() && a[i] < c) ++i;
      while (j < b.size() && b[j] < c) ++j;
      bool ina = (i < a.size() && a[i] == c);
      bool inb = (j < b.size() && b[j] == c);
      if (!ina && !inb) break;
      ++c;
    }
    color_out[e] = c;
    color_out[rev[e]] = c;
    auto& av = used[src[e]];
    av.insert(std::lower_bound(av.begin(), av.end(), c), c);
    auto& bv = used[dst[e]];
    bv.insert(std::lower_bound(bv.begin(), bv.end(), c), c);
    num_colors = std::max(num_colors, (int32_t)(c + 1));
  }
  return num_colors;
}

}  // extern "C"
