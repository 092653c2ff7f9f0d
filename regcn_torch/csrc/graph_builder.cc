// Native snapshot graph builder.
//
// The reference delegates all graph construction to DGL's C++ backend
// (ref:rgcn/utils.py:100-134 builds dgl.graph objects per snapshot);
// this extension turns a [n,3] int64 triple array into the padded flat
// edge arrays + degree norms + unique relation-incidence pairs of a
// snapshot, without Python-loop overhead. The port's copy of the JAX
// package's native/graph_builder.cc, its output arrays and their order
// unchanged.
//
// Build: regcn_torch/data/native.py compiles it with the host C++
// compiler into regcn_torch/_build/ at first use.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// one (relation, entity) incidence pair
struct Pair {
  int32_t rel;
  int32_t ent;
  bool operator<(const Pair& o) const {
    return rel != o.rel || ent != o.ent
               ? (rel < o.rel || (rel == o.rel && ent < o.ent))
               : false;
  }
  bool operator==(const Pair& o) const { return rel == o.rel && ent == o.ent; }
};

PyObject* build_snapshot_arrays(PyObject*, PyObject* args) {
  PyArrayObject* triples_obj;
  long num_nodes, num_rels, edge_pad, rc_pad;
  long rc_src_only = 0;  // 1 = HisRES r2e semantics (source entity only,
                         // ref:hisres_rgcn/utils.py:77-80)
  if (!PyArg_ParseTuple(args, "O!llll|l", &PyArray_Type, &triples_obj,
                        &num_nodes, &num_rels, &edge_pad, &rc_pad,
                        &rc_src_only)) {
    return nullptr;
  }
  PyArrayObject* triples = (PyArrayObject*)PyArray_FROM_OTF(
      (PyObject*)triples_obj, NPY_INT64, NPY_ARRAY_IN_ARRAY);
  if (!triples) return nullptr;
  if (PyArray_NDIM(triples) != 2 || PyArray_DIM(triples, 1) < 3) {
    Py_DECREF(triples);
    PyErr_SetString(PyExc_ValueError, "triples must be [n, >=3]");
    return nullptr;
  }
  const npy_intp n = PyArray_DIM(triples, 0);
  const npy_intp ncol = PyArray_DIM(triples, 1);
  const int64_t* data = (const int64_t*)PyArray_DATA(triples);
  const npy_intp e = 2 * n;
  if (e > edge_pad || 4 * n > rc_pad) {
    Py_DECREF(triples);
    PyErr_SetString(PyExc_ValueError, "padding too small");
    return nullptr;
  }

  npy_intp edge_dims[1] = {edge_pad};
  npy_intp node_dims[1] = {num_nodes};
  npy_intp rc_dims[1] = {rc_pad};
  PyObject* src = PyArray_ZEROS(1, edge_dims, NPY_INT32, 0);
  PyObject* dst = PyArray_ZEROS(1, edge_dims, NPY_INT32, 0);
  PyObject* rel = PyArray_ZEROS(1, edge_dims, NPY_INT32, 0);
  PyObject* emask = PyArray_ZEROS(1, edge_dims, NPY_FLOAT32, 0);
  PyObject* norm = PyArray_ZEROS(1, node_dims, NPY_FLOAT32, 0);
  PyObject* has_in = PyArray_ZEROS(1, node_dims, NPY_FLOAT32, 0);
  PyObject* rc_rel = PyArray_ZEROS(1, rc_dims, NPY_INT32, 0);
  PyObject* rc_ent = PyArray_ZEROS(1, rc_dims, NPY_INT32, 0);
  PyObject* rc_mask = PyArray_ZEROS(1, rc_dims, NPY_FLOAT32, 0);
  if (!src || !dst || !rel || !emask || !norm || !has_in || !rc_rel ||
      !rc_ent || !rc_mask) {
    Py_DECREF(triples);
    return nullptr;
  }

  int32_t* src_p = (int32_t*)PyArray_DATA((PyArrayObject*)src);
  int32_t* dst_p = (int32_t*)PyArray_DATA((PyArrayObject*)dst);
  int32_t* rel_p = (int32_t*)PyArray_DATA((PyArrayObject*)rel);
  float* emask_p = (float*)PyArray_DATA((PyArrayObject*)emask);
  float* norm_p = (float*)PyArray_DATA((PyArrayObject*)norm);
  float* has_p = (float*)PyArray_DATA((PyArrayObject*)has_in);
  int32_t* rcr_p = (int32_t*)PyArray_DATA((PyArrayObject*)rc_rel);
  int32_t* rce_p = (int32_t*)PyArray_DATA((PyArrayObject*)rc_ent);
  float* rcm_p = (float*)PyArray_DATA((PyArrayObject*)rc_mask);

  std::vector<int32_t> in_deg(num_nodes, 0);
  std::vector<Pair> pairs;
  pairs.reserve(4 * n);

  for (npy_intp i = 0; i < n; ++i) {
    const int32_t s = (int32_t)data[i * ncol + 0];
    const int32_t r = (int32_t)data[i * ncol + 1];
    const int32_t o = (int32_t)data[i * ncol + 2];
    // forward edge s -> o type r; inverse o -> s type r + R
    src_p[i] = s;
    dst_p[i] = o;
    rel_p[i] = r;
    src_p[n + i] = o;
    dst_p[n + i] = s;
    rel_p[n + i] = r + (int32_t)num_rels;
    emask_p[i] = 1.0f;
    emask_p[n + i] = 1.0f;
    in_deg[o] += 1;
    in_deg[s] += 1;
    // relation-context incidence: both endpoints for r and r + R
    // (baseline r2e), or source-only (HisRES r2e, rc_src_only=1)
    pairs.push_back({r, s});
    pairs.push_back({r + (int32_t)num_rels, s});
    if (!rc_src_only) {
      pairs.push_back({r, o});
      pairs.push_back({r + (int32_t)num_rels, o});
    }
  }

  for (long v = 0; v < num_nodes; ++v) {
    norm_p[v] = 1.0f / (in_deg[v] > 0 ? (float)in_deg[v] : 1.0f);
    has_p[v] = in_deg[v] > 0 ? 1.0f : 0.0f;
  }

  // destination-sort the real edges (stable, matching numpy's
  // kind="stable" argsort bit for bit) so the Pallas scatter kernel
  // consumes them without an in-step argsort; padded tail stays last
  {
    std::vector<int32_t> idx(e);
    for (npy_intp i = 0; i < e; ++i) idx[i] = (int32_t)i;
    std::stable_sort(idx.begin(), idx.end(),
                     [&](int32_t a, int32_t b) { return dst_p[a] < dst_p[b]; });
    std::vector<int32_t> tmp(e);
    for (npy_intp i = 0; i < e; ++i) tmp[i] = src_p[idx[i]];
    std::copy(tmp.begin(), tmp.end(), src_p);
    for (npy_intp i = 0; i < e; ++i) tmp[i] = dst_p[idx[i]];
    std::copy(tmp.begin(), tmp.end(), dst_p);
    for (npy_intp i = 0; i < e; ++i) tmp[i] = rel_p[idx[i]];
    std::copy(tmp.begin(), tmp.end(), rel_p);
  }

  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  const npy_intp m = (npy_intp)pairs.size();
  if (m > rc_pad) {
    Py_DECREF(triples);
    PyErr_SetString(PyExc_ValueError, "rc padding too small after dedup");
    return nullptr;
  }
  for (npy_intp i = 0; i < m; ++i) {
    rcr_p[i] = pairs[i].rel;
    rce_p[i] = pairs[i].ent;
    rcm_p[i] = 1.0f;
  }

  Py_DECREF(triples);
  return Py_BuildValue("(NNNNNNNNNll)", src, dst, rel, emask, norm, has_in,
                       rc_rel, rc_ent, rc_mask, (long)e, (long)n);
}

PyMethodDef methods[] = {
    {"build_snapshot_arrays", build_snapshot_arrays, METH_VARARGS,
     "Build padded flat edge arrays from [n,3] int64 triples."},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_graph_builder",
    "Native snapshot graph builder", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__graph_builder(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
