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
//    mode (graphs of 50,000 directed edges and more);
//  * the reference-style discrete-event simulator (fu_des_run*): the
//    host baseline a round rate is divided by, and the oracle the edge
//    round's dynamics are held to — per-actor FIFO mailbox, one drain per
//    tick, the timeouts, the mt19937 visit order, optional shared-link
//    contention (quasi-static, with backlog, or the dynamic max-min LMM).
//
// Plain C ABI for ctypes; built with g++ -O3 -std=c++17 -fPIC -shared on
// first use by flow_updating_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <queue>
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

// ---------------------------------------------------------------------------
// Reference-style discrete-event simulator.
//
// Actor semantics mirrored from the reference scripts:
//  * every peer ticks once per simulated second and drains AT MOST ONE
//    mailbox message per tick (the single get_async per loop pass,
//    collectall.py:70-85);
//  * mailbox delivery order = message arrival order (FIFO per arrival);
//  * collect-all: average when all neighbors reported or after `timeout`
//    ticks (collectall.py:87-103);
//  * pairwise: every processed message triggers a 2-party average + reply;
//    neighbors silent for > timeout seconds are re-initiated each tick
//    (pairwise.py:86-100);
//  * per-edge latency in whole ticks (>= 1) models the link delay.
//
// variant: 0 = collect-all, 1 = pairwise.
// Returns number of processed messages (events), fills estimates (= value -
// sum(flows)) and last_avg per node after `ticks` simulated seconds.
// ---------------------------------------------------------------------------

struct Msg {
  int64_t arrival;   // tick at which the message is deliverable
  int64_t seq;       // global sequence for FIFO among equal arrivals
  int32_t edge;      // receiver's ledger edge (v -> u) the message updates
  double flow;
  double estimate;
};
struct MsgLater {
  bool operator()(const Msg& a, const Msg& b) const {
    if (a.arrival != b.arrival) return a.arrival > b.arrival;
    return a.seq > b.seq;
  }
};

// Optional link-level contention model (mirrors models/rounds.py::
// edge_delays): all sends buffered within one tick contend; each SHARED
// link's serialization cost scales with its concurrent-flow count
// (bottleneck fair share); FATPIPE links never share.  delay[e] =
// clamp(round(lat_rounds[e] + max_l load[l] * ser[l]), 1, clamp_d).
struct LinkModel {
  int64_t K = 0;                      // route length (padded)
  const int32_t* edge_links = nullptr;  // (E*K), pad = L
  int64_t L = 0;
  const double* link_ser_rounds = nullptr;  // (L,)
  const uint8_t* link_shared = nullptr;     // (L,)
  const double* lat_rounds = nullptr;       // (E,)
  int64_t clamp_d = 0;                // 0 = unclamped
  // 0 = quasi-static per-tick bottleneck share (the vectorized kernel's
  // model); 1 = dynamic max-min LMM: transfers are continuous flows whose
  // rates are re-solved by progressive filling whenever a transfer starts
  // or finishes — SimGrid's flow-model semantics (SURVEY.md N3), the
  // fidelity oracle the quasi-static approximation is measured against.
  int32_t lmm = 0;
  // quasi-static only: count messages still in flight (sent in earlier
  // ticks, arrival > t) as standing load on their route links — the
  // same-model C++ twin of the kernel's cfg.contention_backlog
  // (models/rounds.py::edge_delays inflight accounting).
  int32_t backlog = 0;
  bool active() const { return edge_links != nullptr; }
};

// One in-flight transfer under the dynamic LMM: a unit message draining
// at the max-min rate (msg/tick) the solver assigns it.
struct Transfer {
  double rem;     // message units remaining (starts at 1.0)
  double rate;    // msg/tick, filled by lmm_solve
  int32_t e;      // sending edge (delivery updates ledger rev[e])
  int64_t t0;     // send tick (origin for the delay clamp)
  double flow_v, est_v;
};

// Progressive-filling max-min: repeatedly find the most-contended
// constraining link, fix its flows at the fair share, release capacity,
// repeat.  Flows crossing no constraining link get +inf (latency-only).
static void lmm_solve(std::vector<Transfer>& act, const LinkModel& lm) {
  const double INF = std::numeric_limits<double>::infinity();
  const size_t F = act.size();
  if (F == 0) return;
  std::vector<double> cap_rem((size_t)lm.L);
  std::vector<int64_t> nflow((size_t)lm.L, 0);
  for (int64_t l = 0; l < lm.L; ++l)
    cap_rem[(size_t)l] = (lm.link_shared[l] && lm.link_ser_rounds[l] > 0.0)
                             ? 1.0 / lm.link_ser_rounds[l]
                             : INF;
  for (size_t f = 0; f < F; ++f)
    for (int64_t k = 0; k < lm.K; ++k) {
      int32_t l = lm.edge_links[(int64_t)act[f].e * lm.K + k];
      if (l < lm.L) nflow[(size_t)l]++;
    }
  auto fair_of = [&](size_t f) {
    // fair share on SHARED links, capped by the flow's own full-rate
    // bound on every ser>0 link it crosses: FATPIPE links never share,
    // but each flow is still rate-capped at the link bandwidth
    // (matches the quasi-static model's 1x ser charge on non-shared
    // links; SURVEY.md N3 / small_platform.xml FATPIPE)
    double mine = INF;
    for (int64_t k = 0; k < lm.K; ++k) {
      int32_t l = lm.edge_links[(int64_t)act[f].e * lm.K + k];
      if (l >= lm.L) continue;
      if (cap_rem[(size_t)l] < INF && nflow[(size_t)l] > 0)
        mine = std::min(mine, cap_rem[(size_t)l] / (double)nflow[(size_t)l]);
      if (!lm.link_shared[l] && lm.link_ser_rounds[l] > 0.0)
        mine = std::min(mine, 1.0 / lm.link_ser_rounds[l]);
    }
    return mine;
  };
  auto fix = [&](size_t f, double rate) {
    act[f].rate = rate;
    for (int64_t k = 0; k < lm.K; ++k) {
      int32_t l = lm.edge_links[(int64_t)act[f].e * lm.K + k];
      if (l < lm.L) {
        if (cap_rem[(size_t)l] < INF)
          cap_rem[(size_t)l] = std::max(cap_rem[(size_t)l] - rate, 0.0);
        nflow[(size_t)l]--;
      }
    }
  };
  std::vector<uint8_t> fixed(F, 0);
  size_t nfixed = 0;
  while (nfixed < F) {
    double best = INF;
    for (size_t f = 0; f < F; ++f)
      if (!fixed[f]) best = std::min(best, fair_of(f));
    if (best == INF) {  // rest cross no constraining link
      for (size_t f = 0; f < F; ++f)
        if (!fixed[f]) act[f].rate = INF;
      break;
    }
    bool any = false;
    for (size_t f = 0; f < F; ++f) {
      if (fixed[f]) continue;
      double mine = fair_of(f);
      if (mine <= best * (1.0 + 1e-12)) {
        fix(f, mine);
        fixed[f] = 1;
        ++nfixed;
        any = true;
      }
    }
    if (!any) {  // numerical guard — fix the single tightest flow
      size_t argf = 0;
      double mine = INF;
      for (size_t f = 0; f < F; ++f)
        if (!fixed[f] && fair_of(f) < mine) mine = fair_of(f), argf = f;
      fix(argf, mine);
      fixed[argf] = 1;
      ++nfixed;
    }
  }
}

static int64_t des_impl(int64_t n, int64_t E, const int32_t* src,
                        const int32_t* dst, const int32_t* rev,
                        const int32_t* delay, const int64_t* row_start,
                        const double* values, int32_t variant, int64_t timeout,
                        int64_t ticks, double* est_out, double* last_avg_out,
                        int64_t obs_every, double mean, double* rmse_out,
                        const LinkModel& lm = LinkModel(),
                        int64_t visit_seed = -1) {
  // Per-edge ledgers, exactly the per-neighbor dicts of a reference Peer.
  std::vector<double> flow((size_t)E, 0.0), est((size_t)E, 0.0);
  std::vector<uint8_t> recv((size_t)E, 0);          // collect-all
  std::vector<int64_t> stamp((size_t)E, 0);         // pairwise
  std::vector<int64_t> ticks_since(n, 0);           // collect-all
  std::vector<int32_t> recv_count(n, 0);
  std::vector<double> last_avg(n, 0.0);
  std::vector<std::priority_queue<Msg, std::vector<Msg>, MsgLater>> mailbox(n);
  int64_t seq = 0, events = 0;

  auto deg = [&](int64_t v) { return row_start[v + 1] - row_start[v]; };

  // contention mode: sends buffer within the tick, delays are assigned at
  // tick end from the per-link concurrent counts (same-model validation
  // target for the vectorized kernel's edge_delays)
  struct PendSend {
    int32_t e;
    double flow_v, est_v;
  };
  std::vector<PendSend> tick_sends;
  std::vector<int64_t> link_cnt(lm.active() ? (size_t)lm.L : 0, 0);

  // dynamic-LMM state: in-flight transfers + the continuous clock they
  // progress on (tick boundaries are integer points of the same axis)
  std::vector<Transfer> act;
  double now_c = 0.0;

  // quasi-static backlog state: per-LINK standing count of messages with
  // arrival > t (the kernel's buf_valid ring occupancy scattered onto
  // route links), maintained incrementally — O(K) per message instead of
  // an O(E*K) rescan per tick; expiry pops as the clock passes arrivals
  std::vector<int64_t> standing_link(
      lm.backlog && lm.active() ? (size_t)lm.L : 0, 0);
  std::priority_queue<std::pair<int64_t, int32_t>,
                      std::vector<std::pair<int64_t, int32_t>>,
                      std::greater<>> expiry;

  auto lmm_advance = [&](double t_end_c) {
    // progress continuous time to t_end_c, re-solving max-min rates at
    // every completion event (the dynamic re-solve the quasi-static
    // model lacks — transfers finishing mid-flight free capacity for
    // the survivors immediately)
    while (now_c < t_end_c - 1e-12 && !act.empty()) {
      lmm_solve(act, lm);
      double dt = t_end_c - now_c;
      bool any_inf = false;
      for (const auto& tr : act) {
        if (tr.rate == std::numeric_limits<double>::infinity())
          any_inf = true;
        else if (tr.rate > 0.0)
          dt = std::min(dt, tr.rem / tr.rate);
      }
      if (any_inf) dt = 0.0;
      if (dt > 0.0) {
        for (auto& tr : act)
          if (tr.rate < std::numeric_limits<double>::infinity())
            tr.rem -= tr.rate * dt;
        now_c += dt;
      }
      bool completed = false;
      for (size_t f = 0; f < act.size();) {
        bool done = act[f].rem <= 1e-9 ||
                    act[f].rate == std::numeric_limits<double>::infinity();
        if (done) {
          const auto& tr = act[f];
          double arr_c = now_c + lm.lat_rounds[tr.e];
          // ceil > t0 guarantees the one-round floor; clamp_d mirrors
          // the ring-buffer delay bound of a delay_depth-bounded run
          int64_t arr = (int64_t)std::ceil(arr_c - 1e-9);
          arr = std::max(arr, tr.t0 + 1);
          if (lm.clamp_d > 0) arr = std::min(arr, tr.t0 + lm.clamp_d);
          mailbox[dst[tr.e]].push(
              Msg{arr, seq++, rev[tr.e], tr.flow_v, tr.est_v});
          act[f] = act.back();
          act.pop_back();
          completed = true;
        } else {
          ++f;
        }
      }
      if (dt == 0.0 && !completed) break;  // safety: no progress possible
    }
    now_c = std::max(now_c, t_end_c);
  };

  auto send = [&](int64_t t, int32_t e) {
    if (lm.active()) {
      tick_sends.push_back({e, flow[e], est[e]});
      return;
    }
    // message travels edge e=(v,u); it updates the receiver's ledger rev[e]
    Msg msg{t + std::max<int32_t>(1, delay[e]), seq++, rev[e], flow[e], 0.0};
    msg.estimate = est[e];  // filled by caller via est[e] (set before send)
    mailbox[dst[e]].push(msg);
  };

  auto flush_tick_sends = [&](int64_t t) {
    if (!lm.active() || tick_sends.empty()) return;
    if (lm.lmm) {
      // dynamic mode: this tick's sends become in-flight transfers,
      // transmitting from the tick boundary (continuous time t); the
      // arrival ceil + one-round floor reproduce the quasi-static
      // minimum of one tick
      for (const auto& p : tick_sends)
        act.push_back(Transfer{1.0, 0.0, p.e, t, p.flow_v, p.est_v});
      tick_sends.clear();
      return;
    }
    std::fill(link_cnt.begin(), link_cnt.end(), 0);
    if (lm.backlog) {
      // standing load: messages sent in earlier ticks whose arrival is
      // still in the future (kernel equivalent: ring occupancy counted
      // AFTER deliver_phase cleared this tick's slot, BEFORE new sends)
      while (!expiry.empty() && expiry.top().first <= t) {
        int32_t e = expiry.top().second;
        expiry.pop();
        for (int64_t k = 0; k < lm.K; ++k) {
          int32_t l = lm.edge_links[(int64_t)e * lm.K + k];
          if (l < lm.L) standing_link[(size_t)l]--;
        }
      }
      for (int64_t l = 0; l < lm.L; ++l) link_cnt[l] += standing_link[l];
    }
    for (const auto& p : tick_sends)
      for (int64_t k = 0; k < lm.K; ++k) {
        int32_t l = lm.edge_links[(int64_t)p.e * lm.K + k];
        if (l < lm.L) link_cnt[l]++;
      }
    for (const auto& p : tick_sends) {
      // float32 accumulation + round-half-even (llrint under the default
      // FE_TONEAREST mode) to match the vectorized kernel bit-for-bit:
      // models/rounds.py::edge_delays computes in float32 and jnp.rint
      // rounds halves to even — llround (half away from zero) would
      // disagree at every half-integer transfer time
      float worst = 0.0f;
      for (int64_t k = 0; k < lm.K; ++k) {
        int32_t l = lm.edge_links[(int64_t)p.e * lm.K + k];
        if (l >= lm.L) continue;
        float load = lm.link_shared[l]
                         ? (float)std::max<int64_t>(link_cnt[l], 1)
                         : 1.0f;
        worst = std::max(worst, load * (float)lm.link_ser_rounds[l]);
      }
      int64_t d = (int64_t)std::llrint((float)lm.lat_rounds[p.e] + worst);
      d = std::max<int64_t>(d, 1);
      if (lm.clamp_d > 0) d = std::min(d, lm.clamp_d);
      mailbox[dst[p.e]].push(
          Msg{t + d, seq++, rev[p.e], p.flow_v, p.est_v});
      if (lm.backlog) {
        for (int64_t k = 0; k < lm.K; ++k) {
          int32_t l = lm.edge_links[(int64_t)p.e * lm.K + k];
          if (l < lm.L) standing_link[(size_t)l]++;
        }
        expiry.push({t + d, p.e});
      }
    }
    tick_sends.clear();
  };

  auto avg_all = [&](int64_t v, int64_t t) {  // collect-all avg_and_send
    double fsum = 0.0, esum = 0.0;
    for (int64_t e = row_start[v]; e < row_start[v + 1]; ++e) {
      fsum += flow[e];
      esum += est[e];
    }
    double estimate = values[v] - fsum;
    double avg = (estimate + esum) / (double)(deg(v) + 1);
    last_avg[v] = avg;
    for (int64_t e = row_start[v]; e < row_start[v + 1]; ++e) {
      flow[e] += avg - est[e];
      est[e] = avg;
      send(t, (int32_t)e);
      recv[e] = 0;
    }
    recv_count[v] = 0;
    ticks_since[v] = 0;
  };

  auto avg_pair = [&](int64_t v, int32_t e, int64_t t) {  // pairwise
    double fsum = 0.0;
    for (int64_t k = row_start[v]; k < row_start[v + 1]; ++k) fsum += flow[k];
    double estimate = values[v] - fsum;
    double avg = (est[e] + estimate) / 2.0;
    last_avg[v] = avg;
    flow[e] += avg - est[e];
    est[e] = avg;
    stamp[e] = t;
    send(t, e);
  };

  // Within-tick node visit order.  The reference's SimGrid scheduler
  // wakes actors in an order the protocol does not control; visit_seed
  // >= 0 re-shuffles the order every tick so callers can MEASURE how
  // much of any oracle-vs-kernel trajectory gap is ordering noise
  // (tests/test_contention.py).  visit_seed < 0 keeps the fixed 0..n-1
  // order (bit-stable baseline).
  std::vector<int64_t> visit((size_t)n);
  for (int64_t v = 0; v < n; ++v) visit[(size_t)v] = v;
  std::mt19937_64 vrng(visit_seed >= 0 ? (uint64_t)visit_seed : 0);

  for (int64_t t = 0; t < ticks; ++t) {
    if (lm.active() && lm.lmm)
      lmm_advance((double)t);  // completions up to this tick boundary
    if (visit_seed >= 0) std::shuffle(visit.begin(), visit.end(), vrng);
    for (int64_t vi = 0; vi < n; ++vi) {
      int64_t v = visit[(size_t)vi];
      // drain at most one deliverable message
      if (!mailbox[v].empty() && mailbox[v].top().arrival <= t) {
        Msg m = mailbox[v].top();
        mailbox[v].pop();
        ++events;
        int32_t e = m.edge;  // v's ledger entry about the sender
        est[e] = m.estimate;
        flow[e] = -m.flow;
        if (variant == 0) {
          if (!recv[e]) {
            recv[e] = 1;
            recv_count[v]++;
          }
          if (recv_count[v] >= deg(v)) avg_all(v, t);
        } else {
          avg_pair(v, e, t);
        }
      }
      // tick
      if (variant == 0) {
        ticks_since[v]++;
        if (ticks_since[v] >= timeout) avg_all(v, t);
      } else {
        for (int64_t e = row_start[v]; e < row_start[v + 1]; ++e)
          if (stamp[e] < t - timeout) avg_pair(v, (int32_t)e, t);
      }
    }
    flush_tick_sends(t);
    // trajectory observation (dynamics-parity oracle): RMSE of the node
    // estimates vs the true mean after every obs_every-th tick
    if (obs_every > 0 && (t + 1) % obs_every == 0) {
      double acc = 0.0;
      for (int64_t v = 0; v < n; ++v) {
        double fsum = 0.0;
        for (int64_t e = row_start[v]; e < row_start[v + 1]; ++e)
          fsum += flow[e];
        double d = values[v] - fsum - mean;
        acc += d * d;
      }
      rmse_out[(t + 1) / obs_every - 1] = std::sqrt(acc / (double)n);
    }
  }

  for (int64_t v = 0; v < n; ++v) {
    double fsum = 0.0;
    for (int64_t e = row_start[v]; e < row_start[v + 1]; ++e) fsum += flow[e];
    est_out[v] = values[v] - fsum;
    last_avg_out[v] = last_avg[v];
  }
  return events;
}

int64_t fu_des_run(int64_t n, int64_t E, const int32_t* src,
                   const int32_t* dst, const int32_t* rev,
                   const int32_t* delay, const int64_t* row_start,
                   const double* values, int32_t variant, int64_t timeout,
                   int64_t ticks, double* est_out, double* last_avg_out) {
  return des_impl(n, E, src, dst, rev, delay, row_start, values, variant,
                  timeout, ticks, est_out, last_avg_out, 0, 0.0, nullptr);
}

// Trajectory variant: additionally fills rmse_out[ticks / obs_every] with
// the RMSE (vs `mean`) of node estimates sampled every obs_every ticks.
int64_t fu_des_run_traj(int64_t n, int64_t E, const int32_t* src,
                        const int32_t* dst, const int32_t* rev,
                        const int32_t* delay, const int64_t* row_start,
                        const double* values, int32_t variant, int64_t timeout,
                        int64_t ticks, double* est_out, double* last_avg_out,
                        int64_t obs_every, double mean, double* rmse_out) {
  return des_impl(n, E, src, dst, rev, delay, row_start, values, variant,
                  timeout, ticks, est_out, last_avg_out, obs_every, mean,
                  rmse_out);
}

// Contention variant: per-tick shared-link bandwidth splitting (see
// LinkModel above) — the same-model oracle for cfg.contention runs.
int64_t fu_des_run_contend(
    int64_t n, int64_t E, const int32_t* src, const int32_t* dst,
    const int32_t* rev, const int32_t* delay, const int64_t* row_start,
    const double* values, int32_t variant, int64_t timeout, int64_t ticks,
    double* est_out, double* last_avg_out, int64_t obs_every, double mean,
    double* rmse_out, int64_t K, const int32_t* edge_links, int64_t L,
    const double* link_ser_rounds, const uint8_t* link_shared,
    const double* lat_rounds, int64_t clamp_d, int64_t visit_seed) {
  LinkModel lm;
  lm.K = K;
  lm.edge_links = edge_links;
  lm.L = L;
  lm.link_ser_rounds = link_ser_rounds;
  lm.link_shared = link_shared;
  lm.lat_rounds = lat_rounds;
  lm.clamp_d = clamp_d;
  return des_impl(n, E, src, dst, rev, delay, row_start, values, variant,
                  timeout, ticks, est_out, last_avg_out, obs_every, mean,
                  rmse_out, lm, visit_seed);
}

// Quasi-static + in-flight backlog: the same-model C++ twin of the
// kernel's cfg.contention_backlog (standing load from messages whose
// arrival is still in the future).
int64_t fu_des_run_contend_backlog(
    int64_t n, int64_t E, const int32_t* src, const int32_t* dst,
    const int32_t* rev, const int32_t* delay, const int64_t* row_start,
    const double* values, int32_t variant, int64_t timeout, int64_t ticks,
    double* est_out, double* last_avg_out, int64_t obs_every, double mean,
    double* rmse_out, int64_t K, const int32_t* edge_links, int64_t L,
    const double* link_ser_rounds, const uint8_t* link_shared,
    const double* lat_rounds, int64_t clamp_d, int64_t visit_seed) {
  LinkModel lm;
  lm.K = K;
  lm.edge_links = edge_links;
  lm.L = L;
  lm.link_ser_rounds = link_ser_rounds;
  lm.link_shared = link_shared;
  lm.lat_rounds = lat_rounds;
  lm.clamp_d = clamp_d;
  lm.backlog = 1;
  return des_impl(n, E, src, dst, rev, delay, row_start, values, variant,
                  timeout, ticks, est_out, last_avg_out, obs_every, mean,
                  rmse_out, lm, visit_seed);
}

// Dynamic max-min LMM variant: transfers are continuous flows; rates are
// re-solved by progressive filling at every start/finish event — the
// SimGrid-fidelity network oracle (closes SURVEY.md N3's remaining
// semantic gap; the quasi-static model above is the TPU kernel's
// approximation of THIS).
int64_t fu_des_run_lmm(
    int64_t n, int64_t E, const int32_t* src, const int32_t* dst,
    const int32_t* rev, const int32_t* delay, const int64_t* row_start,
    const double* values, int32_t variant, int64_t timeout, int64_t ticks,
    double* est_out, double* last_avg_out, int64_t obs_every, double mean,
    double* rmse_out, int64_t K, const int32_t* edge_links, int64_t L,
    const double* link_ser_rounds, const uint8_t* link_shared,
    const double* lat_rounds, int64_t clamp_d, int64_t visit_seed) {
  LinkModel lm;
  lm.K = K;
  lm.edge_links = edge_links;
  lm.L = L;
  lm.link_ser_rounds = link_ser_rounds;
  lm.link_shared = link_shared;
  lm.lat_rounds = lat_rounds;
  lm.clamp_d = clamp_d;
  lm.lmm = 1;
  return des_impl(n, E, src, dst, rev, delay, row_start, values, variant,
                  timeout, ticks, est_out, last_avg_out, obs_every, mean,
                  rmse_out, lm, visit_seed);
}

}  // extern "C"
