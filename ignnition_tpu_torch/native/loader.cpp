// Native data-loading core: JSON graph-sample parsing + index building.
//
// The framework's datasets are tar.gz archives of `data.json` files holding
// lists of graph samples (see ignnition_tpu_torch/data/dataset.py for the format).
// For the full-size KDN datasets (up to ~29 GB) CPython's json module plus
// the per-sample dict walking dominates input-pipeline time; this library
// does the parse and the reference generator's index-building hot loop
// (generator_std_to_framework.py:97-190 semantics) in one pass:
//
//   * a minimal recursive-descent JSON parser whose objects preserve key
//     insertion order (entity index assignment depends on it, exactly like
//     the reference's dict-ordered make_indices);
//   * per-entity contiguous node indexing;
//   * adjacency dicts -> destination-ordered flat src/dst/seq (+ params)
//     arrays.
//
// Exposed as a plain C ABI consumed via ctypes (ignnition_tpu_torch/data/
// native_loader.py; data/native_build.py compiles it at first use); all
// buffers are copied into caller-provided numpy memory, so no ownership
// crosses the boundary except the parse handle.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <charconv>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// JSON value (insertion-ordered objects)
// ---------------------------------------------------------------------

struct Value;
using ValuePtr = std::unique_ptr<Value>;

struct Value {
  enum Kind { Null, Bool, Num, Str, Arr, Obj, NumArr } kind = Null;
  bool b = false;
  double num = 0.0;
  std::string str;
  std::vector<ValuePtr> arr;
  std::vector<double> nums;  // NumArr fast path: flat numeric arrays
  std::vector<std::pair<std::string, ValuePtr>> obj;
  // lazy lookup index for large objects
  mutable std::unordered_map<std::string, const Value*> index;

  const Value* get(const std::string& key) const {
    if (obj.size() > 8) {
      if (index.empty()) {
        for (auto& kv : obj) index.emplace(kv.first, kv.second.get());
      }
      auto it = index.find(key);
      return it == index.end() ? nullptr : it->second;
    }
    for (auto& kv : obj) {
      if (kv.first == key) return kv.second.get();
    }
    return nullptr;
  }
};

struct Parser {
  const char* p;
  const char* end;
  std::string error;

  explicit Parser(const char* buf, size_t len) : p(buf), end(buf + len) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool fail(const char* msg) {
    error = msg;
    return false;
  }

  bool parse_value(Value& out) {
    skip_ws();
    if (p >= end) return fail("unexpected end of input");
    switch (*p) {
      case '{': return parse_object(out);
      case '[': return parse_array(out);
      case '"': out.kind = Value::Str; return parse_string(out.str);
      case 't':
        if (end - p >= 4 && std::memcmp(p, "true", 4) == 0) {
          out.kind = Value::Bool; out.b = true; p += 4; return true;
        }
        return fail("bad literal");
      case 'f':
        if (end - p >= 5 && std::memcmp(p, "false", 5) == 0) {
          out.kind = Value::Bool; out.b = false; p += 5; return true;
        }
        return fail("bad literal");
      case 'n':
        if (end - p >= 4 && std::memcmp(p, "null", 4) == 0) {
          out.kind = Value::Null; p += 4; return true;
        }
        return fail("bad literal");
      default: return parse_number(out);
    }
  }

  bool parse_string(std::string& out) {
    ++p;  // opening quote
    out.clear();
    while (p < end) {
      char c = *p;
      if (c == '"') { ++p; return true; }
      if (c == '\\') {
        if (p + 1 >= end) return fail("bad escape");
        ++p;
        switch (*p) {
          case '"': out.push_back('"'); break;
          case '\\': out.push_back('\\'); break;
          case '/': out.push_back('/'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'n': out.push_back('\n'); break;
          case 'r': out.push_back('\r'); break;
          case 't': out.push_back('\t'); break;
          case 'u': {
            if (end - p < 5) return fail("bad \\u escape");
            unsigned code = 0;
            for (int i = 1; i <= 4; ++i) {
              char h = p[i];
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else return fail("bad \\u escape");
            }
            // UTF-8 encode (BMP only; datasets are ASCII in practice)
            if (code < 0x80) out.push_back(static_cast<char>(code));
            else if (code < 0x800) {
              out.push_back(static_cast<char>(0xC0 | (code >> 6)));
              out.push_back(static_cast<char>(0x80 | (code & 0x3F)));
            } else {
              out.push_back(static_cast<char>(0xE0 | (code >> 12)));
              out.push_back(static_cast<char>(0x80 | ((code >> 6) & 0x3F)));
              out.push_back(static_cast<char>(0x80 | (code & 0x3F)));
            }
            p += 4;
            break;
          }
          default: return fail("bad escape");
        }
        ++p;
      } else {
        out.push_back(c);
        ++p;
      }
    }
    return fail("unterminated string");
  }

  bool parse_number(Value& out) {
    // std::from_chars: locale-INDEPENDENT (review-found: strtod honors
    // LC_NUMERIC, so a comma-decimal locale silently merged array
    // elements like [1,5] into 1.5) and never reads past `end`
    out.kind = Value::Num;
    auto res = std::from_chars(p, end, out.num);
    if (res.ec != std::errc() || res.ptr == p) return fail("bad number");
    p = res.ptr;
    return true;
  }

  bool parse_array(Value& out) {
    ++p;
    skip_ws();
    if (p < end && *p == ']') { out.kind = Value::Arr; ++p; return true; }
    // numeric fast path: most arrays in this format are flat number lists —
    // parse them straight into a vector<double>, no per-element Values
    if (p < end && (*p == '-' || (*p >= '0' && *p <= '9'))) {
      out.kind = Value::NumArr;
      while (true) {
        double d = 0.0;
        auto res = std::from_chars(p, end, d);
        if (res.ec != std::errc() || res.ptr == p) return fail("bad number");
        p = res.ptr;
        out.nums.push_back(d);
        skip_ws();
        if (p >= end) return fail("unterminated array");
        if (*p == ',') {
          ++p;
          skip_ws();
          if (p < end && (*p == '-' || (*p >= '0' && *p <= '9'))) continue;
          break;  // mixed array: demote to DOM below
        }
        if (*p == ']') { ++p; return true; }
        return fail("expected ',' or ']'");
      }
      // mixed array (rare): convert parsed numbers to DOM and continue
      out.kind = Value::Arr;
      for (double d : out.nums) {
        auto v = std::make_unique<Value>();
        v->kind = Value::Num;
        v->num = d;
        out.arr.push_back(std::move(v));
      }
      out.nums.clear();
    } else {
      out.kind = Value::Arr;
    }
    while (true) {
      auto v = std::make_unique<Value>();
      if (!parse_value(*v)) return false;
      out.arr.push_back(std::move(v));
      skip_ws();
      if (p >= end) return fail("unterminated array");
      if (*p == ',') { ++p; continue; }
      if (*p == ']') { ++p; return true; }
      return fail("expected ',' or ']'");
    }
  }

  bool parse_object(Value& out) {
    out.kind = Value::Obj;
    ++p;
    skip_ws();
    if (p < end && *p == '}') { ++p; return true; }
    while (true) {
      skip_ws();
      if (p >= end || *p != '"') return fail("expected object key");
      std::string key;
      if (!parse_string(key)) return false;
      skip_ws();
      if (p >= end || *p != ':') return fail("expected ':'");
      ++p;
      auto v = std::make_unique<Value>();
      if (!parse_value(*v)) return false;
      out.obj.emplace_back(std::move(key), std::move(v));
      skip_ws();
      if (p >= end) return fail("unterminated object");
      if (*p == ',') { ++p; continue; }
      if (*p == '}') { ++p; return true; }
      return fail("expected ',' or '}'");
    }
  }
};

// ---------------------------------------------------------------------
// per-sample entity indexing (reference make_indices semantics)
// ---------------------------------------------------------------------

struct SampleIndex {
  std::unordered_map<std::string, int32_t> node_index;  // node name -> per-entity idx
  std::unordered_map<std::string, std::string> node_entity;
  std::unordered_map<std::string, int32_t> entity_count;
  bool built = false;
};

struct Handle {
  Value root;
  std::vector<SampleIndex> indices;
  std::string error;

  const Value* sample(long i) const {
    if (root.kind != Value::Arr || i < 0 ||
        static_cast<size_t>(i) >= root.arr.size())
      return nullptr;
    return root.arr[i].get();
  }

  SampleIndex& index_for(long i) {
    auto& si = indices[i];
    if (!si.built) {
      const Value* s = sample(i);
      const Value* ents = s ? s->get("entities") : nullptr;
      if (ents && ents->kind == Value::Obj) {
        for (auto& kv : ents->obj) {
          const std::string& node = kv.first;
          const std::string& ent = kv.second->str;
          int32_t idx = si.entity_count[ent]++;
          si.node_index.emplace(node, idx);
          si.node_entity.emplace(node, ent);
        }
      }
      si.built = true;
    }
    return si;
  }
};

}  // namespace

extern "C" {

// Parse a data.json buffer (a JSON list of samples). Returns a handle or
// nullptr; on failure the error is unavailable (caller falls back to python).
void* ign_parse(const char* buf, long len) {
  auto h = std::make_unique<Handle>();
  Parser parser(buf, static_cast<size_t>(len));
  if (!parser.parse_value(h->root) || h->root.kind != Value::Arr) {
    return nullptr;
  }
  h->indices.resize(h->root.arr.size());
  return h.release();
}

void ign_free(void* handle) { delete static_cast<Handle*>(handle); }

long ign_num_samples(void* handle) {
  return static_cast<long>(static_cast<Handle*>(handle)->root.arr.size());
}

// number of nodes of `entity` in sample i (builds the index lazily)
long ign_entity_count(void* handle, long i, const char* entity) {
  auto* h = static_cast<Handle*>(handle);
  if (!h->sample(i)) return -1;
  auto& si = h->index_for(i);
  auto it = si.entity_count.find(entity);
  return it == si.entity_count.end() ? 0 : it->second;
}

// flat length of the numeric list `name` in sample i (-1 if missing)
long ign_feature_len(void* handle, long i, const char* name) {
  auto* h = static_cast<Handle*>(handle);
  const Value* s = h->sample(i);
  const Value* v = s ? s->get(name) : nullptr;
  if (!v) return -1;
  if (v->kind == Value::Num) return 1;
  if (v->kind == Value::NumArr) return static_cast<long>(v->nums.size());
  if (v->kind != Value::Arr) return -1;
  long total = 0;
  for (auto& e : v->arr) {
    if (e->kind == Value::NumArr)
      total += static_cast<long>(e->nums.size());
    else if (e->kind == Value::Arr)
      total += static_cast<long>(e->arr.size());
    else
      total += 1;
  }
  return total;
}

// copy the numeric list `name` (row-major if nested one level) into out
long ign_feature(void* handle, long i, const char* name, float* out, long cap) {
  auto* h = static_cast<Handle*>(handle);
  const Value* s = h->sample(i);
  const Value* v = s ? s->get(name) : nullptr;
  if (!v) return -1;
  long n = 0;
  if (v->kind == Value::Num) {
    if (cap < 1) return -1;
    out[n++] = static_cast<float>(v->num);
    return n;
  }
  if (v->kind == Value::NumArr) {
    if (static_cast<long>(v->nums.size()) > cap) return -1;
    for (double d : v->nums) out[n++] = static_cast<float>(d);
    return n;
  }
  if (v->kind != Value::Arr) return -1;
  for (auto& e : v->arr) {
    if (e->kind == Value::NumArr) {
      for (double d : e->nums) {
        if (n >= cap) return -1;
        out[n++] = static_cast<float>(d);
      }
    } else if (e->kind == Value::Arr) {
      for (auto& inner : e->arr) {
        if (n >= cap) return -1;
        out[n++] = static_cast<float>(inner->num);
      }
    } else {
      if (n >= cap) return -1;
      out[n++] = static_cast<float>(e->num);
    }
  }
  return n;
}

// total number of edges of adjacency `name` in sample i
long ign_adjacency_size(void* handle, long i, const char* name) {
  auto* h = static_cast<Handle*>(handle);
  const Value* s = h->sample(i);
  const Value* adj = s ? s->get(name) : nullptr;
  if (!adj || adj->kind != Value::Obj) return -1;
  long total = 0;
  for (auto& kv : adj->obj) total += static_cast<long>(kv.second->arr.size());
  return total;
}

// Fill destination-ordered edge arrays for adjacency `name`.
// param_dim > 0 means entries look like [src_name, [p0, p1, ...]] and
// `params` receives edge parameters row-major. Returns the edge count, or
// -1 on any format/entity mismatch (caller falls back to python for the
// friendly error message).
long ign_adjacency(void* handle, long i, const char* name,
                   const char* src_entity, const char* dst_entity,
                   int32_t* src, int32_t* dst, int32_t* seq,
                   float* params, long param_dim, long cap) {
  auto* h = static_cast<Handle*>(handle);
  const Value* s = h->sample(i);
  const Value* adj = s ? s->get(name) : nullptr;
  if (!adj || adj->kind != Value::Obj) return -1;
  auto& si = h->index_for(i);
  long n = 0;
  for (auto& kv : adj->obj) {
    const std::string& dst_name = kv.first;
    auto dit = si.node_index.find(dst_name);
    if (dit == si.node_index.end()) return -1;
    if (si.node_entity[dst_name] != dst_entity) return -1;
    const Value* sources = kv.second.get();
    if (sources->kind != Value::Arr) return -1;
    int32_t pos = 0;
    for (auto& sv : sources->arr) {
      if (n >= cap) return -1;
      const std::string* src_name;
      if (sv->kind == Value::Arr) {  // [src, params]
        if (sv->arr.empty() || sv->arr[0]->kind != Value::Str) return -1;
        src_name = &sv->arr[0]->str;
        // source-entity check, same as the plain-string branch below
        // (review-found: a wrong-entity source has a VALID index within
        // its own entity's numbering, so skipping the check silently
        // wires the wrong node; -1 routes to the python path's friendly
        // DatasetError)
        auto peit = si.node_entity.find(*src_name);
        if (peit == si.node_entity.end() || peit->second != src_entity)
          return -1;
        if (param_dim > 0) {
          if (sv->arr.size() < 2) return -1;
          const Value* pv = sv->arr[1].get();
          if (pv->kind == Value::NumArr) {
            if (static_cast<long>(pv->nums.size()) != param_dim) return -1;
            for (long k = 0; k < param_dim; ++k)
              params[n * param_dim + k] = static_cast<float>(pv->nums[k]);
          } else if (pv->kind == Value::Arr) {
            if (static_cast<long>(pv->arr.size()) != param_dim) return -1;
            for (long k = 0; k < param_dim; ++k)
              params[n * param_dim + k] = static_cast<float>(pv->arr[k]->num);
          } else if (param_dim == 1) {
            params[n] = static_cast<float>(pv->num);
          } else {
            return -1;
          }
        }
      } else if (sv->kind == Value::Str) {
        src_name = &sv->str;
        auto eit = si.node_entity.find(*src_name);
        if (eit == si.node_entity.end() || eit->second != src_entity) return -1;
      } else {
        return -1;
      }
      auto sit = si.node_index.find(*src_name);
      if (sit == si.node_index.end()) return -1;
      src[n] = sit->second;
      dst[n] = dit->second;
      seq[n] = pos++;
      ++n;
    }
  }
  return n;
}

// copy a string-list key (e.g. an interleave pattern) as newline-joined
// bytes; returns byte length or -1
long ign_string_list(void* handle, long i, const char* name, char* out,
                     long cap) {
  auto* h = static_cast<Handle*>(handle);
  const Value* s = h->sample(i);
  const Value* v = s ? s->get(name) : nullptr;
  if (!v || v->kind != Value::Arr) return -1;
  long n = 0;
  for (auto& e : v->arr) {
    if (e->kind != Value::Str) return -1;
    for (char c : e->str) {
      if (n >= cap) return -1;
      out[n++] = c;
    }
    if (n >= cap) return -1;
    out[n++] = '\n';
  }
  return n;
}

int ign_has_key(void* handle, long i, const char* name) {
  auto* h = static_cast<Handle*>(handle);
  const Value* s = h->sample(i);
  return (s && s->get(name)) ? 1 : 0;
}

}  // extern "C"
