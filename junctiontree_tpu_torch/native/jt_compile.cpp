// Native host compiler: min-fill triangulation + Jensen junction-tree build.
//
// C++ implementation of the same algorithms as triangulate.py / treebuild.py
// (behavioral equivalent of the reference's construction.py:176-353 and
// 522-601, re-engineered: lazy-invalidation heap, inverted clique index,
// shared-variable candidate separators, union-find Kruskal).  Exposed as a
// C ABI for ctypes; result buffers are allocated here and released with
// jt_free_result.
//
// Determinism: elimination picks min (fill, weight, var-id); weights are
// double (exact for products < 2^53, matching the Python int tie-breaks on
// any sane model).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <unordered_set>
#include <vector>

namespace {

struct HeapEntry {
    int64_t fill;
    double weight;
    int32_t var;
    int64_t version;
    bool operator>(const HeapEntry& o) const {
        if (fill != o.fill) return fill > o.fill;
        if (weight != o.weight) return weight > o.weight;
        return var > o.var;
    }
};

using AdjSet = std::unordered_set<int32_t>;

int64_t fill_count(const std::vector<AdjSet>& adj, int32_t v) {
    std::vector<int32_t> nbrs(adj[v].begin(), adj[v].end());
    int64_t missing = 0;
    for (size_t i = 0; i < nbrs.size(); ++i) {
        const AdjSet& ai = adj[nbrs[i]];
        for (size_t j = i + 1; j < nbrs.size(); ++j)
            if (!ai.count(nbrs[j])) ++missing;
    }
    return missing;
}

double weight_of(const std::vector<AdjSet>& adj, const int64_t* sizes,
                 int32_t v) {
    double w = static_cast<double>(sizes[v]);
    for (int32_t u : adj[v]) w *= static_cast<double>(sizes[u]);
    return w;
}

struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(int32_t n) : parent(n) {
        for (int32_t i = 0; i < n; ++i) parent[i] = i;
    }
    int32_t find(int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int32_t nxt = parent[x];
            parent[x] = root;
            x = nxt;
        }
        return root;
    }
    bool unite(int32_t a, int32_t b) {
        int32_t ra = find(a), rb = find(b);
        if (ra == rb) return false;
        parent[rb] = ra;
        return true;
    }
};

}  // namespace

extern "C" {

struct JtResult {
    // triangulation
    int32_t num_cliques;
    int32_t* clique_offsets;   // [num_cliques + 1]
    int32_t* clique_vars;      // flat, sorted per clique
    int32_t* factor_to_clique; // [num_factors], -1 for empty scope
    int32_t* elim_order;       // [num_vars]
    int32_t num_fill_edges;
    int32_t* fill_edges;       // [2 * num_fill_edges]
    int32_t treewidth;
    // tree
    int32_t num_seps;
    int32_t* sep_offsets;      // [num_seps + 1]
    int32_t* sep_vars;         // flat, sorted per separator
    int32_t* edges;            // [3 * num_seps]: (clique_a, clique_b, sep_ix)
};

void jt_free_result(JtResult* r) {
    if (!r) return;
    std::free(r->clique_offsets);
    std::free(r->clique_vars);
    std::free(r->factor_to_clique);
    std::free(r->elim_order);
    std::free(r->fill_edges);
    std::free(r->sep_offsets);
    std::free(r->sep_vars);
    std::free(r->edges);
    std::free(r);
}

// Returns NULL on allocation failure / invalid input.
JtResult* jt_compile(int32_t num_vars, const int64_t* sizes,
                     int32_t num_factors, const int32_t* factor_offsets,
                     const int32_t* factor_vars) {
    // ---- build adjacency (moral graph) ----
    std::vector<AdjSet> adj(num_vars);
    for (int32_t f = 0; f < num_factors; ++f) {
        int32_t lo = factor_offsets[f], hi = factor_offsets[f + 1];
        for (int32_t i = lo; i < hi; ++i)
            for (int32_t j = i + 1; j < hi; ++j) {
                adj[factor_vars[i]].insert(factor_vars[j]);
                adj[factor_vars[j]].insert(factor_vars[i]);
            }
    }

    // ---- min-fill elimination with lazy-invalidation heap ----
    std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                        std::greater<HeapEntry>>
        heap;
    std::vector<int64_t> version(num_vars, 0);
    std::vector<char> alive(num_vars, 1);
    for (int32_t v = 0; v < num_vars; ++v)
        heap.push({fill_count(adj, v), weight_of(adj, sizes, v), v, 0});

    std::vector<std::vector<int32_t>> cliques;
    std::vector<std::vector<int32_t>> var_in_cliques(num_vars);
    std::vector<int32_t> elim_order;
    std::vector<int32_t> fill_pairs;
    elim_order.reserve(num_vars);

    std::vector<int32_t> nbrs, dirty, rescore_list;
    for (int32_t step = 0; step < num_vars; ++step) {
        int32_t best = -1;
        while (!heap.empty()) {
            HeapEntry e = heap.top();
            heap.pop();
            if (alive[e.var] && e.version == version[e.var]) {
                best = e.var;
                break;
            }
        }
        if (best < 0) return nullptr;  // invariant breach
        elim_order.push_back(best);

        nbrs.assign(adj[best].begin(), adj[best].end());
        std::sort(nbrs.begin(), nbrs.end());

        // fill edges among neighbors
        dirty.clear();
        for (size_t i = 0; i < nbrs.size(); ++i)
            for (size_t j = i + 1; j < nbrs.size(); ++j) {
                int32_t u = nbrs[i], w = nbrs[j];
                if (!adj[u].count(w)) {
                    adj[u].insert(w);
                    adj[w].insert(u);
                    fill_pairs.push_back(u);
                    fill_pairs.push_back(w);
                    dirty.push_back(u);
                    dirty.push_back(w);
                }
            }

        // remove best
        for (int32_t u : nbrs) adj[u].erase(best);
        alive[best] = 0;

        // cluster = nbrs + best; maxclique unless contained in an existing
        // clique that includes best
        std::vector<int32_t> cluster(nbrs);
        cluster.push_back(best);
        std::sort(cluster.begin(), cluster.end());
        bool contained = false;
        for (int32_t ci : var_in_cliques[best]) {
            const std::vector<int32_t>& c = cliques[ci];
            if (c.size() >= cluster.size() &&
                std::includes(c.begin(), c.end(), cluster.begin(),
                              cluster.end())) {
                contained = true;
                break;
            }
        }
        if (!contained) {
            int32_t ci = static_cast<int32_t>(cliques.size());
            cliques.push_back(cluster);
            for (int32_t v : cluster) var_in_cliques[v].push_back(ci);
        }

        // rescore neighbors + fill-edge endpoints' neighborhoods
        rescore_list = nbrs;
        for (int32_t u : dirty)
            for (int32_t x : adj[u])
                if (alive[x]) rescore_list.push_back(x);
        std::sort(rescore_list.begin(), rescore_list.end());
        rescore_list.erase(
            std::unique(rescore_list.begin(), rescore_list.end()),
            rescore_list.end());
        for (int32_t v : rescore_list) {
            if (!alive[v]) continue;
            ++version[v];
            heap.push({fill_count(adj, v), weight_of(adj, sizes, v), v,
                       version[v]});
        }
    }

    int32_t num_cliques = static_cast<int32_t>(cliques.size());

    // clique weights
    std::vector<double> cw(num_cliques, 1.0);
    for (int32_t c = 0; c < num_cliques; ++c)
        for (int32_t v : cliques[c]) cw[c] *= static_cast<double>(sizes[v]);

    // ---- factor assignment: smallest-weight containing clique ----
    std::vector<int32_t> f2c(num_factors, -1);
    for (int32_t f = 0; f < num_factors; ++f) {
        int32_t lo = factor_offsets[f], hi = factor_offsets[f + 1];
        if (lo == hi) continue;  // empty scope
        std::vector<int32_t> fv(factor_vars + lo, factor_vars + hi);
        std::sort(fv.begin(), fv.end());
        int32_t best_ci = -1;
        double best_w = 0;
        for (int32_t ci : var_in_cliques[fv[0]]) {
            const std::vector<int32_t>& c = cliques[ci];
            if (std::includes(c.begin(), c.end(), fv.begin(), fv.end())) {
                if (best_ci < 0 || cw[ci] < best_w) {
                    best_ci = ci;
                    best_w = cw[ci];
                }
            }
        }
        if (best_ci < 0) return nullptr;  // invariant breach
        f2c[f] = best_ci;
    }

    // ---- Jensen/Kruskal tree build over shared-variable pairs ----
    struct Cand {
        int32_t a, b;
        int32_t sep_len;
        double wsum;
    };
    std::vector<Cand> cands;
    {
        std::unordered_set<int64_t> seen;
        for (int32_t v = 0; v < num_vars; ++v) {
            const std::vector<int32_t>& group = var_in_cliques[v];
            for (size_t i = 0; i < group.size(); ++i)
                for (size_t j = i + 1; j < group.size(); ++j) {
                    int32_t a = std::min(group[i], group[j]);
                    int32_t b = std::max(group[i], group[j]);
                    int64_t key =
                        (static_cast<int64_t>(a) << 32) | b;
                    if (seen.insert(key).second) {
                        // sep length via sorted intersection count
                        const auto& ca = cliques[a];
                        const auto& cb = cliques[b];
                        int32_t cnt = 0;
                        size_t x = 0, y = 0;
                        while (x < ca.size() && y < cb.size()) {
                            if (ca[x] < cb[y]) ++x;
                            else if (ca[x] > cb[y]) ++y;
                            else { ++cnt; ++x; ++y; }
                        }
                        cands.push_back({a, b, cnt, cw[a] + cw[b]});
                    }
                }
        }
    }
    std::sort(cands.begin(), cands.end(), [](const Cand& l, const Cand& r) {
        if (l.sep_len != r.sep_len) return l.sep_len > r.sep_len;
        if (l.wsum != r.wsum) return l.wsum < r.wsum;
        if (l.a != r.a) return l.a < r.a;
        return l.b < r.b;
    });

    UnionFind uf(num_cliques);
    std::vector<std::vector<int32_t>> seps;
    std::vector<int32_t> edge_list;  // triples
    for (const Cand& c : cands) {
        if (static_cast<int32_t>(seps.size()) == num_cliques - 1) break;
        if (uf.unite(c.a, c.b)) {
            const auto& ca = cliques[c.a];
            const auto& cb = cliques[c.b];
            std::vector<int32_t> sep;
            std::set_intersection(ca.begin(), ca.end(), cb.begin(), cb.end(),
                                  std::back_inserter(sep));
            edge_list.push_back(c.a);
            edge_list.push_back(c.b);
            edge_list.push_back(static_cast<int32_t>(seps.size()));
            seps.push_back(std::move(sep));
        }
    }
    // link remaining components with empty separators (smallest-weight rep)
    if (static_cast<int32_t>(seps.size()) < num_cliques - 1) {
        std::vector<int32_t> rep;  // one representative per root
        std::vector<int32_t> root_of(num_cliques);
        for (int32_t c = 0; c < num_cliques; ++c) root_of[c] = uf.find(c);
        std::vector<int32_t> best_rep(num_cliques, -1);
        for (int32_t c = 0; c < num_cliques; ++c) {
            int32_t r = root_of[c];
            if (best_rep[r] < 0 || cw[c] < cw[best_rep[r]] ||
                (cw[c] == cw[best_rep[r]] && c < best_rep[r]))
                best_rep[r] = c;
        }
        for (int32_t r = 0; r < num_cliques; ++r)
            if (best_rep[r] >= 0 && root_of[r] == r) rep.push_back(best_rep[r]);
        std::sort(rep.begin(), rep.end(), [&](int32_t x, int32_t y) {
            if (cw[x] != cw[y]) return cw[x] < cw[y];
            return x < y;
        });
        for (size_t i = 1; i < rep.size(); ++i) {
            if (uf.unite(rep[0], rep[i])) {
                edge_list.push_back(rep[0]);
                edge_list.push_back(rep[i]);
                edge_list.push_back(static_cast<int32_t>(seps.size()));
                seps.push_back({});
            }
        }
    }

    // ---- pack result ----
    JtResult* r = static_cast<JtResult*>(std::calloc(1, sizeof(JtResult)));
    if (!r) return nullptr;
    r->num_cliques = num_cliques;
    r->clique_offsets =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * (num_cliques + 1)));
    size_t total_cv = 0;
    for (const auto& c : cliques) total_cv += c.size();
    r->clique_vars =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<size_t>(total_cv, 1)));
    int32_t off = 0, tw = 0;
    for (int32_t c = 0; c < num_cliques; ++c) {
        r->clique_offsets[c] = off;
        for (int32_t v : cliques[c]) r->clique_vars[off++] = v;
        tw = std::max<int32_t>(tw, static_cast<int32_t>(cliques[c].size()));
    }
    r->clique_offsets[num_cliques] = off;
    r->treewidth = tw - 1;

    r->factor_to_clique =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max(num_factors, 1)));
    std::memcpy(r->factor_to_clique, f2c.data(),
                sizeof(int32_t) * num_factors);
    r->elim_order =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max(num_vars, 1)));
    std::memcpy(r->elim_order, elim_order.data(), sizeof(int32_t) * num_vars);
    r->num_fill_edges = static_cast<int32_t>(fill_pairs.size() / 2);
    r->fill_edges =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<size_t>(fill_pairs.size(), 1)));
    std::memcpy(r->fill_edges, fill_pairs.data(),
                sizeof(int32_t) * fill_pairs.size());

    r->num_seps = static_cast<int32_t>(seps.size());
    r->sep_offsets =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * (seps.size() + 1)));
    size_t total_sv = 0;
    for (const auto& s : seps) total_sv += s.size();
    r->sep_vars =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<size_t>(total_sv, 1)));
    off = 0;
    for (size_t s = 0; s < seps.size(); ++s) {
        r->sep_offsets[s] = off;
        for (int32_t v : seps[s]) r->sep_vars[off++] = v;
    }
    r->sep_offsets[seps.size()] = off;
    r->edges =
        static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<size_t>(edge_list.size(), 1)));
    std::memcpy(r->edges, edge_list.data(), sizeof(int32_t) * edge_list.size());
    return r;
}

}  // extern "C"
