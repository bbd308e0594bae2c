// Edge-list (TSV/CSV) parser of embiggen_tpu_torch: file -> (edge ids,
// weights, edge-type ids, node and edge-type names), a copy of the JAX
// package's embiggen_tpu/native/edge_list_parser.cpp. `from_csv` takes it
// for first-appearance numbering; its plain version is the csv-module reader
// in embiggen_tpu_torch/native/__init__.py.
//
// Exposed through a C ABI for ctypes. One pass over the file read whole:
// scan lines splitting on the separator, intern node and edge-type names in
// open-addressing hash tables (ids in order of first appearance, a row's
// source before its destination), emit int32 edge arrays. Rows with fewer
// columns than the highest one asked for, or an empty source or
// destination, are skipped.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct ParsedEdgeList {
  int64_t n_edges;
  int64_t n_nodes;
  int64_t n_edge_types;
  int32_t* sources;        // [n_edges]
  int32_t* destinations;   // [n_edges]
  float* weights;          // [n_edges] or nullptr
  int32_t* edge_types;     // [n_edges] or nullptr
  char* node_names;        // concatenated, '\n'-separated
  int64_t node_names_len;
  char* edge_type_names;   // concatenated, '\n'-separated
  int64_t edge_type_names_len;
  char error[256];
};

namespace {

// FNV-1a
static inline uint64_t hash_bytes(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= (unsigned char)s[i];
    h *= 1099511628211ull;
  }
  return h;
}

struct Interner {
  // open addressing over (offset,len) into names buffer
  std::vector<int64_t> table;  // index into entries+1, 0 = empty
  std::vector<std::pair<int64_t, int32_t>> entries;  // (offset, len)
  std::string names;
  size_t mask;

  Interner() : table(1 << 16, 0), mask((1 << 16) - 1) {}

  void grow() {
    size_t new_size = table.size() * 2;
    std::vector<int64_t> fresh(new_size, 0);
    size_t new_mask = new_size - 1;
    for (size_t id = 0; id < entries.size(); ++id) {
      const char* s = names.data() + entries[id].first;
      uint64_t h = hash_bytes(s, entries[id].second);
      size_t slot = h & new_mask;
      while (fresh[slot] != 0) slot = (slot + 1) & new_mask;
      fresh[slot] = (int64_t)id + 1;
    }
    table.swap(fresh);
    mask = new_mask;
  }

  int32_t intern(const char* s, size_t n) {
    if (entries.size() * 2 > table.size()) grow();
    uint64_t h = hash_bytes(s, n);
    size_t slot = h & mask;
    while (true) {
      int64_t e = table[slot];
      if (e == 0) {
        int64_t off = (int64_t)names.size();
        names.append(s, n);
        entries.emplace_back(off, (int32_t)n);
        table[slot] = (int64_t)entries.size();
        return (int32_t)entries.size() - 1;
      }
      auto& ent = entries[e - 1];
      if (ent.second == (int32_t)n &&
          memcmp(names.data() + ent.first, s, n) == 0) {
        return (int32_t)(e - 1);
      }
      slot = (slot + 1) & mask;
    }
  }

  // '\n'-joined names
  std::string joined() const {
    std::string out;
    out.reserve(names.size() + entries.size());
    for (auto& ent : entries) {
      out.append(names.data() + ent.first, ent.second);
      out.push_back('\n');
    }
    return out;
  }
};

static char* dup_string(const std::string& s, int64_t* len_out) {
  char* buf = (char*)malloc(s.size() + 1);
  memcpy(buf, s.data(), s.size());
  buf[s.size()] = 0;
  *len_out = (int64_t)s.size();
  return buf;
}

}  // namespace

ParsedEdgeList* parse_edge_list(
    const char* path, char sep, int skip_header,
    int src_col, int dst_col, int weight_col, int type_col) {
  auto* out = new ParsedEdgeList();
  memset(out, 0, sizeof(ParsedEdgeList));

  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(out->error, sizeof(out->error), "cannot open %s", path);
    return out;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* data = (char*)malloc(size + 1);
  if (fread(data, 1, size, f) != (size_t)size) {
    snprintf(out->error, sizeof(out->error), "short read on %s", path);
    fclose(f);
    free(data);
    return out;
  }
  fclose(f);
  data[size] = '\n';

  Interner nodes, types;
  std::vector<int32_t> srcs, dsts, etypes;
  std::vector<float> weights;
  bool has_weights = weight_col >= 0;
  bool has_types = type_col >= 0;
  int max_col = src_col;
  if (dst_col > max_col) max_col = dst_col;
  if (weight_col > max_col) max_col = weight_col;
  if (type_col > max_col) max_col = type_col;

  const char* p = data;
  const char* end = data + size;
  int line_no = 0;
  std::vector<std::pair<const char*, size_t>> fields;
  fields.reserve(max_col + 2);
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p + 1);
    if (!line_end) line_end = end;
    ++line_no;
    if (line_no == 1 && skip_header) {
      p = line_end + 1;
      continue;
    }
    if (line_end > p) {
      fields.clear();
      const char* fs = p;
      for (const char* q = p; q <= line_end; ++q) {
        if (q == line_end || *q == sep) {
          fields.emplace_back(fs, (size_t)(q - fs));
          fs = q + 1;
        }
      }
      if ((int)fields.size() > max_col) {
        auto sv = fields[src_col];
        auto dv = fields[dst_col];
        // trim \r
        if (sv.second && sv.first[sv.second - 1] == '\r') sv.second--;
        if (dv.second && dv.first[dv.second - 1] == '\r') dv.second--;
        if (sv.second && dv.second) {
          srcs.push_back(nodes.intern(sv.first, sv.second));
          dsts.push_back(nodes.intern(dv.first, dv.second));
          if (has_weights) {
            weights.push_back(strtof(fields[weight_col].first, nullptr));
          }
          if (has_types) {
            auto tv = fields[type_col];
            if (tv.second && tv.first[tv.second - 1] == '\r') tv.second--;
            etypes.push_back(types.intern(tv.first, tv.second));
          }
        }
      }
    }
    p = line_end + 1;
  }
  free(data);

  out->n_edges = (int64_t)srcs.size();
  out->n_nodes = (int64_t)nodes.entries.size();
  out->n_edge_types = (int64_t)types.entries.size();
  out->sources = (int32_t*)malloc(srcs.size() * 4);
  memcpy(out->sources, srcs.data(), srcs.size() * 4);
  out->destinations = (int32_t*)malloc(dsts.size() * 4);
  memcpy(out->destinations, dsts.data(), dsts.size() * 4);
  if (has_weights) {
    out->weights = (float*)malloc(weights.size() * 4);
    memcpy(out->weights, weights.data(), weights.size() * 4);
  }
  if (has_types) {
    out->edge_types = (int32_t*)malloc(etypes.size() * 4);
    memcpy(out->edge_types, etypes.data(), etypes.size() * 4);
  }
  out->node_names = dup_string(nodes.joined(), &out->node_names_len);
  out->edge_type_names = dup_string(types.joined(), &out->edge_type_names_len);
  return out;
}

void free_parsed_edge_list(ParsedEdgeList* p) {
  if (!p) return;
  free(p->sources);
  free(p->destinations);
  free(p->weights);
  free(p->edge_types);
  free(p->node_names);
  free(p->edge_type_names);
  delete p;
}

}  // extern "C"
