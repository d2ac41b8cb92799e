// Dinic max-flow / min-cut oracle for validating the push-relabel solves
// (ops/mincut.py and the CUDA kernels on csrc/push_relabel.cuh); the
// port's copy of the JAX package's native/maxflow.cpp.
//
// This is NOT the BK maxflow library the reference links against
// (maxflow/README.TXT): it is an independent, from-scratch Dinic
// implementation with a C ABI so tests can cross-check the capped
// push-relabel on region sizes where brute-force enumeration is impossible.
//
// Graph model matches ops/mincut.py: S*S grid nodes, per-node terminal
// capacities (excess = source cap, cap_t = sink cap), 4 forward-direction
// edge capacity planes (reverse capacity 0). Returns the min-cut side per
// node: 1 = source side (accept proposal), 0 = sink side.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Edge {
  int to;
  double cap;
  int rev;  // index of reverse edge in graph[to]
};

class Dinic {
 public:
  explicit Dinic(int n) : graph_(n), level_(n), iter_(n) {}

  void add_edge(int from, int to, double cap, double rcap = 0.0) {
    graph_[from].push_back({to, cap, static_cast<int>(graph_[to].size())});
    graph_[to].push_back({from, rcap, static_cast<int>(graph_[from].size()) - 1});
  }

  double max_flow(int s, int t) {
    double flow = 0.0;
    while (bfs(s, t)) {
      std::fill(iter_.begin(), iter_.end(), 0);
      double f;
      while ((f = dfs(s, t, 1e300)) > 0.0) flow += f;
    }
    return flow;
  }

  // After max_flow: marks nodes that can REACH t in the residual graph
  // (the sink side of the canonical min cut). Reverse BFS from t: v is a
  // predecessor of u iff residual cap(v -> u) > 0, found via the paired
  // reverse stub graph_[e.to][e.rev].
  void sink_side(int t, std::vector<uint8_t>* out) const {
    std::vector<uint8_t> vis(graph_.size(), 0);
    std::queue<int> q;
    q.push(t);
    vis[t] = 1;
    while (!q.empty()) {
      int u = q.front();
      q.pop();
      for (const Edge& e : graph_[u]) {
        int v = e.to;
        if (!vis[v] && graph_[v][e.rev].cap > 1e-9) {
          vis[v] = 1;
          q.push(v);
        }
      }
    }
    out->assign(vis.begin(), vis.end());
  }

 private:
  bool bfs(int s, int t) {
    std::fill(level_.begin(), level_.end(), -1);
    std::queue<int> q;
    level_[s] = 0;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Edge& e : graph_[v]) {
        if (e.cap > 1e-12 && level_[e.to] < 0) {
          level_[e.to] = level_[v] + 1;
          q.push(e.to);
        }
      }
    }
    return level_[t] >= 0;
  }

  double dfs(int v, int t, double f) {
    if (v == t) return f;
    for (int& i = iter_[v]; i < static_cast<int>(graph_[v].size()); ++i) {
      Edge& e = graph_[v][i];
      if (e.cap > 1e-12 && level_[v] < level_[e.to]) {
        double d = dfs(e.to, t, f < e.cap ? f : e.cap);
        if (d > 0.0) {
          e.cap -= d;
          graph_[e.to][e.rev].cap += d;
          return d;
        }
      }
    }
    return 0.0;
  }

  std::vector<std::vector<Edge>> graph_;
  std::vector<int> level_;
  std::vector<int> iter_;
};

}  // namespace

extern "C" {

// Solves the grid expansion min-cut.
//   s: window side; excess/cap_t: [s*s]; cap_fw: [4, s*s] forward-edge caps
//   with direction order (dx, dy) in {(1,0), (0,1), (-1,1), (1,1)}.
//   accept_out: [s*s] uint8, 1 = source side (accept proposal).
// Returns the max-flow value.
double grid_mincut(int s, const float* excess, const float* cap_t,
                   const float* cap_fw, uint8_t* accept_out) {
  const int n = s * s;
  const int src = n;
  const int snk = n + 1;
  Dinic dinic(n + 2);

  static const int kDirs[4][2] = {{1, 0}, {0, 1}, {-1, 1}, {1, 1}};

  for (int i = 0; i < n; ++i) {
    if (excess[i] > 0.0f) dinic.add_edge(src, i, excess[i]);
    if (cap_t[i] > 0.0f) dinic.add_edge(i, snk, cap_t[i]);
  }
  for (int k = 0; k < 4; ++k) {
    for (int y = 0; y < s; ++y) {
      for (int x = 0; x < s; ++x) {
        int qx = x + kDirs[k][0];
        int qy = y + kDirs[k][1];
        if (qx < 0 || qx >= s || qy < 0 || qy >= s) continue;
        float cap = cap_fw[k * n + y * s + x];
        if (cap > 0.0f) dinic.add_edge(y * s + x, qy * s + qx, cap);
      }
    }
  }

  double flow = dinic.max_flow(src, snk);
  // accept = NOT able to reach the sink in the residual graph — the same
  // convention as the push-relabel kernels (free nodes count as accept,
  // which matches BK's default SOURCE segment for disconnected nodes).
  std::vector<uint8_t> side;
  dinic.sink_side(snk, &side);
  for (int i = 0; i < n; ++i) accept_out[i] = side[i] ? 0 : 1;
  return flow;
}

}  // extern "C"
