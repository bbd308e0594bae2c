// Host graph helpers of embiggen_tpu_torch: a copy of the functions of the
// JAX package's embiggen_tpu/native/graph_algos.cpp that the port's host
// code calls (alias tables, the spanning forest, the binary panel's sort and
// sweep, pair sorts and dedup, the symmetric CSR build, connected components
// and DAGResnik's MICA block), built with g++ by
// embiggen_tpu_torch/native/__init__.py and called through ctypes. Every
// function has a plain numpy version beside its wrapper there.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Walker alias tables of every node's neighbour distribution, rows split
// over std::threads. row_ptr: [n_nodes+1] int64 CSR offsets; weights:
// [n_edges] float32. Outputs aligned with col_idx: prob_out [n_edges] f32,
// alias_out [n_edges] int32 (offsets inside the row).
void build_alias_tables(const int64_t* row_ptr, int64_t n_nodes,
                        const float* weights, int64_t /*n_edges*/,
                        float* prob_out, int32_t* alias_out) {
  int n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_nodes < 4096) n_threads = 1;

  auto worker = [&](int64_t r0, int64_t r1) {
    std::vector<double> p;
    std::vector<int32_t> small, large;
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t s = row_ptr[r], e = row_ptr[r + 1];
      const int64_t d = e - s;
      if (d == 0) continue;
      double total = 0.0;
      for (int64_t i = s; i < e; ++i) total += (double)weights[i];
      if (total <= 0.0) total = 1.0;
      p.resize(d);
      small.clear();
      large.clear();
      bool uniform = true;
      const double scale = (double)d / total;
      for (int64_t i = 0; i < d; ++i) {
        p[i] = (double)weights[s + i] * scale;
        if (std::fabs(p[i] - 1.0) > 1e-12) uniform = false;
      }
      if (uniform) {
        for (int64_t i = 0; i < d; ++i) {
          prob_out[s + i] = 1.0f;
          alias_out[s + i] = (int32_t)i;
        }
        continue;
      }
      for (int64_t i = 0; i < d; ++i)
        (p[i] < 1.0 ? small : large).push_back((int32_t)i);
      while (!small.empty() && !large.empty()) {
        const int32_t sm = small.back();
        small.pop_back();
        const int32_t lg = large.back();
        large.pop_back();
        prob_out[s + sm] = (float)p[sm];
        alias_out[s + sm] = lg;
        p[lg] -= (1.0 - p[sm]);
        (p[lg] < 1.0 ? small : large).push_back(lg);
      }
      for (int32_t i : large) {
        prob_out[s + i] = 1.0f;
        alias_out[s + i] = i;
      }
      for (int32_t i : small) {  // numerical leftovers
        prob_out[s + i] = 1.0f;
        alias_out[s + i] = i;
      }
    }
  };

  if (n_threads == 1) {
    worker(0, n_nodes);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_nodes + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * chunk;
    const int64_t r1 = std::min(n_nodes, r0 + chunk);
    if (r0 >= r1) break;
    threads.emplace_back(worker, r0, r1);
  }
  for (auto& th : threads) th.join();
}

// Union-find spanning forest over an explicitly ordered edge list: edge
// order[i] joins the forest iff its endpoints are in different components
// at that point (connected_holdout's forest).
void spanning_forest(
    const int32_t* src, const int32_t* dst, const int64_t* order,
    int64_t m, int64_t n_nodes, uint8_t* in_forest) {
  std::vector<int32_t> parent(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = (int32_t)i;
  auto find = [&](int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t nxt = parent[x];
      parent[x] = root;
      x = nxt;
    }
    return root;
  };
  std::fill(in_forest, in_forest + m, 0);
  for (int64_t i = 0; i < m; ++i) {
    const int64_t e = order[i];
    const int32_t a = find(src[e]);
    const int32_t b = find(dst[e]);
    if (a != b) {
      parent[a] = b;
      in_forest[e] = 1;
    }
  }
}

// AUROC (Mann-Whitney with midrank ties) + AUPRC (sklearn
// average_precision step integration) in two linear passes over
// score-ascending-sorted (scores, labels): the binary panel's areas.
void ranking_metrics_sorted(
    const double* scores_asc, const uint8_t* labels_asc, int64_t n,
    double* out_auroc, double* out_auprc) {
  int64_t npos = 0;
  for (int64_t i = 0; i < n; ++i) npos += labels_asc[i];
  const int64_t nneg = n - npos;
  if (npos == 0 || nneg == 0) {
    *out_auroc = std::nan("");
    *out_auprc = npos == 0 ? std::nan("") : 1.0;
    return;
  }
  // ascending pass: positive midrank sum per tie group
  double rank_sum = 0.0;
  int64_t a = 0;
  while (a < n) {
    int64_t b = a + 1;
    while (b < n && scores_asc[b] == scores_asc[a]) ++b;
    int64_t pg = 0;
    for (int64_t i = a; i < b; ++i) pg += labels_asc[i];
    rank_sum += (double)pg * 0.5 * ((double)(a + 1) + (double)b);
    a = b;
  }
  *out_auroc = (rank_sum - (double)npos * (npos + 1) / 2.0)
               / ((double)npos * (double)nneg);
  // descending pass: step-integrated precision-recall
  double tp = 0.0, fp = 0.0, ap = 0.0, recall_prev = 0.0;
  int64_t i = n - 1;
  while (i >= 0) {
    int64_t j = i - 1;
    while (j >= 0 && scores_asc[j] == scores_asc[i]) --j;
    for (int64_t k = i; k > j; --k) {
      if (labels_asc[k]) tp += 1.0;
      else fp += 1.0;
    }
    const double prec = tp / std::max(tp + fp, 1e-12);
    const double rec = tp / (double)npos;
    ap += (rec - recall_prev) * prec;
    recall_prev = rec;
    i = j;
  }
  *out_auprc = ap;
}

// Stable lexicographic argsort of (src, dst) pairs in two counting-sort
// passes (by dst, then by src), the COO -> CSR sort: O(E + N) sequential
// traffic a pass. Node ids must be in [0, n_nodes).
void counting_sort_pairs(
    const int64_t* src, const int64_t* dst, int64_t e, int64_t n_nodes,
    int64_t* order) {
  std::vector<int64_t> perm1(e);
  std::vector<int64_t> counts(n_nodes + 1, 0);
  // pass 1: stable sort by dst
  for (int64_t i = 0; i < e; ++i) counts[dst[i] + 1]++;
  for (int64_t v = 0; v < n_nodes; ++v) counts[v + 1] += counts[v];
  for (int64_t i = 0; i < e; ++i) perm1[counts[dst[i]]++] = i;
  // pass 2: stable sort by src over the dst-ordered permutation
  std::fill(counts.begin(), counts.end(), 0);
  for (int64_t i = 0; i < e; ++i) counts[src[i] + 1]++;
  for (int64_t v = 0; v < n_nodes; ++v) counts[v + 1] += counts[v];
  for (int64_t i = 0; i < e; ++i) {
    const int64_t j = perm1[i];
    order[counts[src[j]]++] = j;
  }
}

// Fused counting-sort + first-occurrence extraction over (src, dst)
// pairs: writes into first_idx (capacity e) the ORIGINAL indices of the
// first occurrence of each distinct pair, in sorted pair order, and
// returns the distinct count. The stable two-pass sort guarantees the
// first original occurrence leads each equal run, so callers keep
// reproducible draws (the negative graph's in-batch dedup).
int64_t sort_unique_pairs(
    const int64_t* src, const int64_t* dst, int64_t e, int64_t n_nodes,
    int64_t* first_idx) {
  std::vector<int64_t> perm1(e);
  std::vector<int64_t> order(e);
  std::vector<int64_t> counts(n_nodes + 1, 0);
  for (int64_t i = 0; i < e; ++i) counts[dst[i] + 1]++;
  for (int64_t v = 0; v < n_nodes; ++v) counts[v + 1] += counts[v];
  for (int64_t i = 0; i < e; ++i) perm1[counts[dst[i]]++] = i;
  std::fill(counts.begin(), counts.end(), 0);
  for (int64_t i = 0; i < e; ++i) counts[src[i] + 1]++;
  for (int64_t v = 0; v < n_nodes; ++v) counts[v + 1] += counts[v];
  for (int64_t i = 0; i < e; ++i) {
    const int64_t j = perm1[i];
    order[counts[src[j]]++] = j;
  }
  int64_t out = 0;
  int64_t prev_s = -1, prev_d = -1;
  for (int64_t i = 0; i < e; ++i) {
    const int64_t j = order[i];
    if (src[j] != prev_s || dst[j] != prev_d) {
      first_idx[out++] = j;
      prev_s = src[j];
      prev_d = dst[j];
    }
  }
  return out;
}

// LSD radix argsort of uint64 keys (stable). Passes whose byte is constant
// across all keys are skipped, so keys of 32 bits (the float32 scores'
// order-preserving transform) sort in 4 passes of sequential traffic.
void radix_argsort_u64(
    const uint64_t* keys, int64_t n, int64_t* order) {
  std::vector<uint64_t> k0(keys, keys + n), k1(n);
  std::vector<int64_t> o1(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  uint64_t* src_k = k0.data();
  uint64_t* dst_k = k1.data();
  int64_t* src_o = order;
  int64_t* dst_o = o1.data();
  int64_t count[256];
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = pass * 8;
    std::fill(count, count + 256, 0);
    for (int64_t i = 0; i < n; ++i) count[(src_k[i] >> shift) & 0xFF]++;
    bool constant = false;
    for (int b = 0; b < 256; ++b) {
      if (count[b] == n) { constant = true; break; }
    }
    if (constant) continue;
    int64_t pos[256];
    int64_t acc = 0;
    for (int b = 0; b < 256; ++b) { pos[b] = acc; acc += count[b]; }
    for (int64_t i = 0; i < n; ++i) {
      const int b = (src_k[i] >> shift) & 0xFF;
      dst_k[pos[b]] = src_k[i];
      dst_o[pos[b]] = src_o[i];
      pos[b]++;
    }
    std::swap(src_k, dst_k);
    std::swap(src_o, dst_o);
  }
  if (src_o != order) std::copy(src_o, src_o + n, order);
}


// Fused symmetrize + counting-sort + dedup CSR build for unweighted,
// untyped undirected graphs (negative graphs, holdout splits, generators):
// two passes plus a parallel per-row sort.
// src/dst: n_pairs arbitrary arcs (both-direction duplicates fine).
// Writes row_ptr [n_nodes+1] and col_idx [<= 2*n_pairs] (symmetrized,
// per-row sorted, deduplicated). Returns the final arc count.
int64_t build_sym_csr(const int32_t* src, const int32_t* dst,
                      int64_t n_pairs, int64_t n_nodes,
                      int64_t* row_ptr, int32_t* col_idx) {
  std::vector<int64_t> counts(n_nodes + 1, 0);
  for (int64_t i = 0; i < n_pairs; ++i) {
    counts[src[i] + 1]++;
    if (src[i] != dst[i]) counts[dst[i] + 1]++;
  }
  for (int64_t r = 0; r < n_nodes; ++r) counts[r + 1] += counts[r];
  // counts now holds the row starts of the RAW (pre-dedup) layout.
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  const int64_t raw_arcs = counts[n_nodes];
  std::vector<int32_t> raw(raw_arcs);
  for (int64_t i = 0; i < n_pairs; ++i) {
    raw[cursor[src[i]]++] = dst[i];
    if (src[i] != dst[i]) raw[cursor[dst[i]]++] = src[i];
  }
  // Parallel per-row sort + in-row dedup into per-row unique counts.
  int n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_nodes < 4096) n_threads = 1;
  std::vector<int64_t> uniq(n_nodes, 0);
  auto worker = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      int32_t* beg = raw.data() + counts[r];
      int32_t* end = raw.data() + counts[r + 1];
      std::sort(beg, end);
      uniq[r] = std::unique(beg, end) - beg;
    }
  };
  if (n_threads == 1) {
    worker(0, n_nodes);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n_nodes + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t r0 = t * chunk;
      const int64_t r1 = std::min(n_nodes, r0 + chunk);
      if (r0 >= r1) break;
      threads.emplace_back(worker, r0, r1);
    }
    for (auto& th : threads) th.join();
  }
  row_ptr[0] = 0;
  for (int64_t r = 0; r < n_nodes; ++r) row_ptr[r + 1] = row_ptr[r] + uniq[r];
  // Compact the deduped rows into col_idx (parallel: disjoint ranges).
  auto compact = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      std::copy(raw.data() + counts[r], raw.data() + counts[r] + uniq[r],
                col_idx + row_ptr[r]);
    }
  };
  if (n_threads == 1) {
    compact(0, n_nodes);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n_nodes + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int64_t r0 = t * chunk;
      const int64_t r1 = std::min(n_nodes, r0 + chunk);
      if (r0 >= r1) break;
      threads.emplace_back(compact, r0, r1);
    }
    for (auto& th : threads) th.join();
  }
  return row_ptr[n_nodes];
}

// Union-find connected components over an arc list, arcs read as
// undirected. comp_out[i]: node i's component, numbered 0..n_comp-1 in the
// order of each component's smallest node. Returns n_comp.
int64_t connected_components(const int32_t* sources, const int32_t* dests,
                             int64_t n_arcs, int64_t n_nodes,
                             int32_t* comp_out) {
  std::vector<int32_t> parent(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = (int32_t)i;
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t a = 0; a < n_arcs; ++a) {
    int32_t rs = find(sources[a]), rd = find(dests[a]);
    if (rs != rd) parent[rs] = rd;
  }
  int64_t n_comp = 0;
  std::vector<int32_t> remap(n_nodes, -1);
  for (int64_t i = 0; i < n_nodes; ++i) {
    int32_t root = find((int32_t)i);
    if (remap[root] < 0) remap[root] = (int32_t)n_comp++;
    comp_out[i] = remap[root];
  }
  return n_comp;
}

// DAGResnik's MICA block over a CSR ancestor closure whose rows are sorted
// ascending by IC rank (rank 0 the most informative): a pair's most
// informative common ancestor is the first common entry of its two rows,
// found by one two-pointer merge. out [n_src, n_dst] float64: its IC, 0
// where the rows share nothing. Source rows split over std::threads.
void dag_mica_block(const int64_t* indptr, const int32_t* ranks,
                    const double* ic_by_rank,
                    const int64_t* src, int64_t n_src,
                    const int64_t* dst, int64_t n_dst,
                    int n_threads, double* out) {
  auto worker = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const int64_t s0 = indptr[src[i]], s1 = indptr[src[i] + 1];
      double* row = out + i * n_dst;
      for (int64_t j = 0; j < n_dst; ++j) {
        int64_t a = s0, b = indptr[dst[j]];
        const int64_t b1 = indptr[dst[j] + 1];
        double sim = 0.0;
        while (a < s1 && b < b1) {
          const int32_t ra = ranks[a], rb = ranks[b];
          if (ra == rb) { sim = ic_by_rank[ra]; break; }
          if (ra < rb) ++a; else ++b;
        }
        row[j] = sim;
      }
    }
  };
  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_src < 64) n_threads = 1;
  std::vector<std::thread> threads;
  const int64_t chunk = (n_src + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t i0 = t * chunk;
    const int64_t i1 = std::min(n_src, i0 + chunk);
    if (i0 >= i1) break;
    threads.emplace_back(worker, i0, i1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
