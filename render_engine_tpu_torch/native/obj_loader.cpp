// Native Wavefront OBJ parser: the parse core of the port's model loader
// (render_engine_tpu_torch/models/obj_loader.py), a copy of the JAX
// package's render_engine_tpu/native/obj_loader.cpp.
//
// The Python parser in models/obj_loader.py is the semantic specification,
// and this core reproduces it exactly (corner dedup keyed by the literal
// face token, fan triangulation, negative index resolution against the
// running counts, usemtl slots in first-use order) at native speed for
// large assets. MTL resolution, the normal fill and the material table
// stay in Python: this parser returns the structural arrays and the
// ordered usemtl / mtllib records needed to replay that logic.
//
// Built at first use by native/build.py (g++ -O3 -std=c++17 -shared -fPIC
// into render_engine_tpu_torch/_build/) and loaded through ctypes. A parse
// anomaly returns nullptr and the caller takes the Python parser.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> v, n, uv;     // per-corner, packed (3/3/2 wide)
  std::vector<int32_t> tris;       // 3 ids per triangle
  std::vector<int32_t> tri_slot;   // usemtl slot per triangle (0 = default)
  std::string names;               // '\0'-joined usemtl names, first-use order
  std::vector<int32_t> name_lib;   // index of latest mtllib at first use (-1)
  std::string libs;                // '\0'-joined mtllib tokens, in order
  int32_t n_names = 0, n_libs = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* token_end(const char* p, const char* end) {
  while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  return p;
}

ObjData* obj_parse_impl(const char* path) {
  FILE* fh = fopen(path, "rb");
  if (!fh) return nullptr;
  fseek(fh, 0, SEEK_END);
  long size = ftell(fh);
  if (size < 0) {  // directory / unseekable stream: degrade to Python parser
    fclose(fh);
    return nullptr;
  }
  fseek(fh, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  if (size && fread(&buf[0], 1, size, fh) != static_cast<size_t>(size)) {
    fclose(fh);
    return nullptr;
  }
  fclose(fh);

  auto* d = new ObjData();
  std::vector<float> pos, nrm, tex;  // raw v/vn/vt records (3/3/2 wide)
  std::unordered_map<std::string, int32_t> corner_map;
  std::unordered_map<std::string, int32_t> slot_map;
  int32_t cur_slot = 0;  // 0 = default material
  std::vector<int32_t> face_ids;

  const char* p = buf.data();
  const char* end = p + buf.size();
  bool ok = true;

  // resolve one face corner token (e.g. "3/1/2", "-1//4") to a packed
  // corner id, deduped by the LITERAL token (python corner_map parity)
  auto corner = [&](const char* tp, const char* te) -> int32_t {
    std::string token(tp, te - tp);
    auto it = corner_map.find(token);
    if (it != corner_map.end()) return it->second;
    // split on '/'
    long idx[3] = {0, 0, 0};
    bool has[3] = {false, false, false};
    int part = 0;
    const char* s = tp;
    for (const char* q = tp; q <= te; ++q) {
      if (q == te || *q == '/') {
        if (q > s) {
          char* endp = nullptr;
          idx[part] = strtol(s, &endp, 10);
          if (endp != q) return -1;  // malformed number
          has[part] = true;
        }
        s = q + 1;
        if (++part > 2 && q < te) return -1;
      }
    }
    if (!has[0]) return -1;
    long np_ = static_cast<long>(pos.size() / 3);
    long nt_ = static_cast<long>(tex.size() / 2);
    long nn_ = static_cast<long>(nrm.size() / 3);
    long vi = idx[0] > 0 ? idx[0] - 1 : np_ + idx[0];
    if (vi < 0 || vi >= np_) return -1;
    long ti = -1;
    if (has[1]) {
      ti = idx[1] > 0 ? idx[1] - 1 : nt_ + idx[1];
      if (ti < 0 || ti >= nt_) return -1;
    }
    long ni = -1;
    if (has[2]) {
      ni = idx[2] > 0 ? idx[2] - 1 : nn_ + idx[2];
      if (ni < 0 || ni >= nn_) return -1;
    }
    int32_t id = static_cast<int32_t>(d->v.size() / 3);
    d->v.insert(d->v.end(), {pos[3 * vi], pos[3 * vi + 1], pos[3 * vi + 2]});
    if (ti >= 0)
      d->uv.insert(d->uv.end(), {tex[2 * ti], tex[2 * ti + 1]});
    else
      d->uv.insert(d->uv.end(), {0.0f, 0.0f});
    if (ni >= 0)
      d->n.insert(d->n.end(), {nrm[3 * ni], nrm[3 * ni + 1], nrm[3 * ni + 2]});
    else
      d->n.insert(d->n.end(), {0.0f, 0.0f, 0.0f});
    corner_map.emplace(std::move(token), id);
    return id;
  };

  while (p < end && ok) {
    p = skip_ws(p, end);
    const char* le = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!le) le = end;
    const char* t0 = p;
    const char* t0e = token_end(t0, le);
    size_t tl = t0e - t0;
    if (tl == 0 || *t0 == '#') {
      p = le + 1;
      continue;
    }
    auto read_floats = [&](std::vector<float>& dst, int count) {
      const char* q = t0e;
      for (int i = 0; i < count; ++i) {
        q = skip_ws(q, le);
        char* endp = nullptr;
        double val = strtod(q, &endp);
        if (endp == q || endp > le) {
          ok = false;
          return;
        }
        dst.push_back(static_cast<float>(val));
        q = endp;
      }
    };
    if (tl == 1 && t0[0] == 'v') {
      read_floats(pos, 3);
    } else if (tl == 2 && t0[0] == 'v' && t0[1] == 'n') {
      read_floats(nrm, 3);
    } else if (tl == 2 && t0[0] == 'v' && t0[1] == 't') {
      read_floats(tex, 2);
    } else if (tl == 6 && memcmp(t0, "mtllib", 6) == 0) {
      const char* q = skip_ws(t0e, le);
      const char* qe = token_end(q, le);
      if (qe > q) {
        d->libs.append(q, qe - q);
        d->libs.push_back('\0');
        d->n_libs++;
      }
    } else if (tl == 6 && memcmp(t0, "usemtl", 6) == 0) {
      const char* q = skip_ws(t0e, le);
      const char* qe = token_end(q, le);
      if (qe > q) {
        std::string name(q, qe - q);
        auto it = slot_map.find(name);
        if (it == slot_map.end()) {
          int32_t slot = static_cast<int32_t>(slot_map.size()) + 1;
          slot_map.emplace(name, slot);
          d->names.append(name);
          d->names.push_back('\0');
          d->name_lib.push_back(d->n_libs - 1);
          d->n_names++;
          cur_slot = slot;
        } else {
          cur_slot = it->second;
        }
      }
    } else if (tl == 1 && t0[0] == 'f') {
      face_ids.clear();
      const char* q = t0e;
      while (true) {
        q = skip_ws(q, le);
        if (q >= le) break;
        const char* qe = token_end(q, le);
        int32_t id = corner(q, qe);
        if (id < 0) {
          ok = false;
          break;
        }
        face_ids.push_back(id);
        q = qe;
      }
      for (size_t k = 1; ok && k + 1 < face_ids.size(); ++k) {
        d->tris.insert(d->tris.end(),
                       {face_ids[0], face_ids[k], face_ids[k + 1]});
        d->tri_slot.push_back(cur_slot);
      }
    }
    p = le + 1;
  }

  if (!ok) {
    delete d;
    return nullptr;
  }
  return d;
}

}  // namespace

extern "C" {

ObjData* obj_parse(const char* path) {
  // Never let a C++ exception cross the ctypes boundary: any failure
  // (bad_alloc, length_error, ...) must degrade to the documented Python
  // parser fallback instead of terminating the process.
  try {
    return obj_parse_impl(path);
  } catch (...) {
    return nullptr;
  }
}

void obj_counts(ObjData* d, int64_t* nv, int64_t* nf, int32_t* n_names,
                int32_t* n_libs, int64_t* names_len, int64_t* libs_len) {
  *nv = static_cast<int64_t>(d->v.size() / 3);
  *nf = static_cast<int64_t>(d->tris.size() / 3);
  *n_names = d->n_names;
  *n_libs = d->n_libs;
  *names_len = static_cast<int64_t>(d->names.size());
  *libs_len = static_cast<int64_t>(d->libs.size());
}

void obj_copy(ObjData* d, float* v, float* n, float* uv, int32_t* tris,
              int32_t* tri_slot, char* names, int32_t* name_lib,
              char* libs) {
  if (!d->v.empty()) memcpy(v, d->v.data(), d->v.size() * sizeof(float));
  if (!d->n.empty()) memcpy(n, d->n.data(), d->n.size() * sizeof(float));
  if (!d->uv.empty()) memcpy(uv, d->uv.data(), d->uv.size() * sizeof(float));
  if (!d->tris.empty())
    memcpy(tris, d->tris.data(), d->tris.size() * sizeof(int32_t));
  if (!d->tri_slot.empty())
    memcpy(tri_slot, d->tri_slot.data(),
           d->tri_slot.size() * sizeof(int32_t));
  if (!d->names.empty()) memcpy(names, d->names.data(), d->names.size());
  if (!d->name_lib.empty())
    memcpy(name_lib, d->name_lib.data(),
           d->name_lib.size() * sizeof(int32_t));
  if (!d->libs.empty()) memcpy(libs, d->libs.data(), d->libs.size());
}

void obj_free(ObjData* d) { delete d; }

}  // extern "C"
