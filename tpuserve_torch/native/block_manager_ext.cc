// CPython extension binding for the native block manager.
//
// ctypes adds ~2-5us per call, which swamps these micro-operations; the
// C API keeps the per-call overhead ~100ns so the native core actually
// beats the pure-Python BlockManager on the scheduler hot path.
//
// Module: _tpuserve_torch_native, type: BlockManagerCore (named apart from
// the JAX package's _tpuserve_native so neither can load in place of the
// other).  Exceptions mirror the
// Python implementation (MemoryError on OOM, KeyError on unknown sequence,
// AssertionError on duplicate allocate) so it is a true drop-in.
//
// Build: tpuserve_torch/native/__init__.py (g++ with the interpreter's
// include dir, into build/tpuserve_torch/ at first use).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <vector>

#include "block_manager.hh"

namespace {

using tpuserve::BlockManager;

struct CoreObject {
  PyObject_HEAD
  BlockManager* bm;
};

bool tokens_from_list(PyObject* list, std::vector<int32_t>* out) {
  if (!PyList_Check(list)) {
    PyErr_SetString(PyExc_TypeError, "expected a list of ints");
    return false;
  }
  Py_ssize_t n = PyList_GET_SIZE(list);
  out->resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    long v = PyLong_AsLong(PyList_GET_ITEM(list, i));
    if (v == -1 && PyErr_Occurred()) return false;
    (*out)[i] = static_cast<int32_t>(v);
  }
  return true;
}

PyObject* list_from_blocks(const int32_t* blocks, int64_t n) {
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (int64_t i = 0; i < n; ++i)
    PyList_SET_ITEM(out, i, PyLong_FromLong(blocks[i]));
  return out;
}

int core_init(CoreObject* self, PyObject* args, PyObject* kwds) {
  int num_blocks, block_size, enable_prefix = 1;
  static const char* kwlist[] = {"num_blocks", "block_size",
                                 "enable_prefix_caching", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "ii|p",
                                   const_cast<char**>(kwlist), &num_blocks,
                                   &block_size, &enable_prefix))
    return -1;
  delete self->bm;
  self->bm = new BlockManager(num_blocks, block_size, enable_prefix != 0);
  return 0;
}

void core_dealloc(CoreObject* self) {
  delete self->bm;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* core_num_free_blocks(CoreObject* self, PyObject*) {
  return PyLong_FromLong(self->bm->num_free_blocks());
}

PyObject* core_num_seqs(CoreObject* self, PyObject*) {
  return PyLong_FromLong(self->bm->num_seqs());
}

PyObject* core_blocks_needed(CoreObject* self, PyObject* arg) {
  long long n = PyLong_AsLongLong(arg);
  if (n == -1 && PyErr_Occurred()) return nullptr;
  return PyLong_FromLongLong(self->bm->blocks_needed(n));
}

PyObject* core_can_allocate(CoreObject* self, PyObject* arg) {
  long long n = PyLong_AsLongLong(arg);
  if (n == -1 && PyErr_Occurred()) return nullptr;
  return PyBool_FromLong(self->bm->can_allocate(n));
}

PyObject* core_prefix_hits(CoreObject* self, PyObject*) {
  return PyLong_FromLongLong(self->bm->prefix_hits());
}

PyObject* core_prefix_queries(CoreObject* self, PyObject*) {
  return PyLong_FromLongLong(self->bm->prefix_queries());
}

PyObject* core_lookup_prefix(CoreObject* self, PyObject* args) {
  PyObject* list;
  int count_stats = 1;
  if (!PyArg_ParseTuple(args, "O|p", &list, &count_stats)) return nullptr;
  std::vector<int32_t> tokens;
  if (!tokens_from_list(list, &tokens)) return nullptr;
  std::vector<int32_t> out(tokens.size() + 1);  // >= max possible blocks
  int64_t n = self->bm->lookup_prefix(tokens.data(),
                                      static_cast<int64_t>(tokens.size()),
                                      out.data(),
                                      static_cast<int64_t>(out.size()),
                                      count_stats != 0);
  return list_from_blocks(out.data(), n);
}

PyObject* core_num_cached_blocks(CoreObject* self, PyObject*) {
  return PyLong_FromLong(self->bm->num_cached_blocks());
}

PyObject* core_num_restoring_blocks(CoreObject* self, PyObject*) {
  return PyLong_FromLong(self->bm->num_restoring_blocks());
}

PyObject* core_prefix_chain(CoreObject* self, PyObject* arg) {
  std::vector<int32_t> tokens;
  if (!tokens_from_list(arg, &tokens)) return nullptr;
  std::vector<uint64_t> out(tokens.size() + 1);
  int64_t n = self->bm->prefix_chain(tokens.data(),
                                     static_cast<int64_t>(tokens.size()),
                                     out.data(),
                                     static_cast<int64_t>(out.size()));
  PyObject* list = PyList_New(n);
  if (!list) return nullptr;
  for (int64_t i = 0; i < n; ++i)
    PyList_SET_ITEM(list, i, PyLong_FromUnsignedLongLong(out[i]));
  return list;
}

PyObject* core_prefix_resolvable(CoreObject* self, PyObject* arg) {
  unsigned long long h = PyLong_AsUnsignedLongLong(arg);
  if (h == static_cast<unsigned long long>(-1) && PyErr_Occurred())
    return nullptr;
  return PyBool_FromLong(self->bm->prefix_resolvable(h));
}

PyObject* core_set_record_evictions(CoreObject* self, PyObject* arg) {
  int on = PyObject_IsTrue(arg);
  if (on < 0) return nullptr;
  self->bm->set_record_evictions(on != 0);
  Py_RETURN_NONE;
}

PyObject* core_take_evictions(CoreObject* self, PyObject*) {
  int64_t n = self->bm->num_evictions();
  std::vector<int32_t> blocks(static_cast<size_t>(n));
  std::vector<uint64_t> hashes(static_cast<size_t>(n));
  n = self->bm->take_evictions(blocks.data(), hashes.data(), n);
  PyObject* list = PyList_New(n);
  if (!list) return nullptr;
  for (int64_t i = 0; i < n; ++i) {
    PyObject* pair = Py_BuildValue(
        "iK", blocks[static_cast<size_t>(i)],
        static_cast<unsigned long long>(hashes[static_cast<size_t>(i)]));
    if (!pair) { Py_DECREF(list); return nullptr; }
    PyList_SET_ITEM(list, i, pair);
  }
  return list;
}

bool hashes_from_list(PyObject* list, std::vector<uint64_t>* out) {
  if (!PyList_Check(list)) {
    PyErr_SetString(PyExc_TypeError, "expected a list of hash ints");
    return false;
  }
  Py_ssize_t n = PyList_GET_SIZE(list);
  out->resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    unsigned long long v =
        PyLong_AsUnsignedLongLong(PyList_GET_ITEM(list, i));
    if (v == static_cast<unsigned long long>(-1) && PyErr_Occurred())
      return false;
    (*out)[i] = static_cast<uint64_t>(v);
  }
  return true;
}

PyObject* core_begin_restore(CoreObject* self, PyObject* arg) {
  std::vector<uint64_t> hashes;
  if (!hashes_from_list(arg, &hashes)) return nullptr;
  std::vector<int32_t> blocks(hashes.size());
  int64_t n = self->bm->begin_restore(hashes.data(),
                                      static_cast<int64_t>(hashes.size()),
                                      blocks.data());
  if (n < 0) Py_RETURN_NONE;  // pool can't cover it, like Python's None
  return list_from_blocks(blocks.data(), n);
}

PyObject* core_commit_restore(CoreObject* self, PyObject* args) {
  PyObject* hashes_list;
  PyObject* blocks_list;
  if (!PyArg_ParseTuple(args, "OO", &hashes_list, &blocks_list))
    return nullptr;
  std::vector<uint64_t> hashes;
  std::vector<int32_t> blocks;
  if (!hashes_from_list(hashes_list, &hashes)) return nullptr;
  if (!tokens_from_list(blocks_list, &blocks)) return nullptr;
  if (hashes.size() != blocks.size()) {
    PyErr_SetString(PyExc_ValueError, "hashes/blocks length mismatch");
    return nullptr;
  }
  return PyLong_FromLongLong(self->bm->commit_restore(
      hashes.data(), blocks.data(),
      static_cast<int64_t>(hashes.size())));
}

PyObject* core_abort_restore(CoreObject* self, PyObject* arg) {
  std::vector<int32_t> blocks;
  if (!tokens_from_list(arg, &blocks)) return nullptr;
  self->bm->abort_restore(blocks.data(),
                          static_cast<int64_t>(blocks.size()));
  Py_RETURN_NONE;
}

PyObject* core_allocate(CoreObject* self, PyObject* args) {
  const char* seq_id;
  PyObject* tokens_list;
  PyObject* shared_list = nullptr;
  if (!PyArg_ParseTuple(args, "sO|O", &seq_id, &tokens_list, &shared_list))
    return nullptr;
  std::vector<int32_t> tokens, shared;
  if (!tokens_from_list(tokens_list, &tokens)) return nullptr;
  if (shared_list && shared_list != Py_None &&
      !tokens_from_list(shared_list, &shared))
    return nullptr;
  // shared may legitimately exceed blocks_needed (over-long cached prefix);
  // the result is shared + fresh, so size for both
  std::vector<int32_t> out(
      shared.size() +
      static_cast<size_t>(self->bm->blocks_needed(tokens.size())) + 1);
  int64_t n = self->bm->allocate(seq_id, tokens.data(),
                                 static_cast<int64_t>(tokens.size()),
                                 shared.data(),
                                 static_cast<int64_t>(shared.size()),
                                 out.data(),
                                 static_cast<int64_t>(out.size()));
  if (n == -2) {
    PyErr_Format(PyExc_AssertionError, "%s already allocated", seq_id);
    return nullptr;
  }
  if (n == -1) {
    PyErr_SetString(PyExc_MemoryError, "out of KV blocks");
    return nullptr;
  }
  return list_from_blocks(out.data(), n);
}

PyObject* core_needs_new_block(CoreObject* self, PyObject* arg) {
  const char* seq_id = PyUnicode_AsUTF8(arg);
  if (!seq_id) return nullptr;
  int r = self->bm->needs_new_block(seq_id);
  if (r < 0) {
    PyErr_SetObject(PyExc_KeyError, arg);
    return nullptr;
  }
  return PyBool_FromLong(r);
}

PyObject* core_can_append(CoreObject* self, PyObject* arg) {
  const char* seq_id = PyUnicode_AsUTF8(arg);
  if (!seq_id) return nullptr;
  int r = self->bm->can_append(seq_id);
  if (r < 0) {
    PyErr_SetObject(PyExc_KeyError, arg);
    return nullptr;
  }
  return PyBool_FromLong(r);
}

PyObject* core_reserve(CoreObject* self, PyObject* args) {
  const char* seq_id;
  long long total;
  if (!PyArg_ParseTuple(args, "sL", &seq_id, &total)) return nullptr;
  int64_t r = self->bm->reserve(seq_id, total);
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, seq_id);
    return nullptr;
  }
  if (r == -1) {
    PyErr_SetString(PyExc_MemoryError, "out of KV blocks on reserve");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* core_advance(CoreObject* self, PyObject* args) {
  const char* seq_id;
  long long n;
  if (!PyArg_ParseTuple(args, "sL", &seq_id, &n)) return nullptr;
  int64_t r = self->bm->advance(seq_id, n);
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, seq_id);
    return nullptr;
  }
  if (r == -3) {
    PyErr_SetString(PyExc_ValueError, "advance beyond reserved capacity");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* core_append_slot(CoreObject* self, PyObject* arg) {
  const char* seq_id = PyUnicode_AsUTF8(arg);
  if (!seq_id) return nullptr;
  int64_t r = self->bm->append_slot(seq_id);
  if (r == -2) {
    PyErr_SetObject(PyExc_KeyError, arg);
    return nullptr;
  }
  if (r == -1) {
    PyErr_SetString(PyExc_MemoryError, "out of KV blocks on append");
    return nullptr;
  }
  return PyLong_FromLongLong(r);
}

PyObject* core_slot_for_token(CoreObject* self, PyObject* args) {
  const char* seq_id;
  long long idx;
  if (!PyArg_ParseTuple(args, "sL", &seq_id, &idx)) return nullptr;
  int64_t r = self->bm->slot_for_token(seq_id, idx);
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, seq_id);
    return nullptr;
  }
  if (r == -3) {
    PyErr_SetString(PyExc_IndexError, "token index out of range");
    return nullptr;
  }
  return PyLong_FromLongLong(r);
}

PyObject* core_block_table(CoreObject* self, PyObject* arg) {
  const char* seq_id = PyUnicode_AsUTF8(arg);
  if (!seq_id) return nullptr;
  // two-pass: size query then fill
  int64_t n = self->bm->block_table(seq_id, nullptr, 0);
  if (n == -2) {
    PyErr_SetObject(PyExc_KeyError, arg);
    return nullptr;
  }
  std::vector<int32_t> out(static_cast<size_t>(n));
  self->bm->block_table(seq_id, out.data(), n);
  return list_from_blocks(out.data(), n);
}

PyObject* core_free(CoreObject* self, PyObject* args) {
  const char* seq_id;
  int cache_blocks = 1;
  if (!PyArg_ParseTuple(args, "s|p", &seq_id, &cache_blocks)) return nullptr;
  self->bm->free_seq(seq_id, cache_blocks != 0);
  Py_RETURN_NONE;
}

// ---- per-cycle batched ops ------------------------------------------------
// One boundary crossing per engine cycle instead of 2-3 per row: the
// seq-id list converts once, results land straight in caller-owned numpy
// buffers via the buffer protocol (no per-row Python lists).

bool seq_ids_from_list(PyObject* list, std::vector<const char*>* out) {
  if (!PyList_Check(list)) {
    PyErr_SetString(PyExc_TypeError, "expected a list of str seq ids");
    return false;
  }
  Py_ssize_t n = PyList_GET_SIZE(list);
  out->resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GET_ITEM(list, i));
    if (!s) return false;
    (*out)[i] = s;
  }
  return true;
}

// Writable C-contiguous int32 buffer with at least min_items items
// (numpy int32 arrays satisfy this); caller must PyBuffer_Release.
bool i32_buffer(PyObject* obj, Py_buffer* view, Py_ssize_t min_items) {
  if (PyObject_GetBuffer(obj, view,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) != 0)
    return false;
  if (view->itemsize != 4 || view->len < min_items * 4) {
    PyBuffer_Release(view);
    PyErr_SetString(PyExc_TypeError,
                    "expected a C-contiguous int32 buffer of sufficient "
                    "size");
    return false;
  }
  return true;
}

PyObject* core_decode_shortfall(CoreObject* self, PyObject* arg) {
  std::vector<const char*> ids;
  if (!seq_ids_from_list(arg, &ids)) return nullptr;
  int64_t r = self->bm->decode_shortfall(ids.data(),
                                         static_cast<int64_t>(ids.size()));
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, "unknown sequence in decode_shortfall");
    return nullptr;
  }
  return PyLong_FromLongLong(r);
}

PyObject* core_charge_decode(CoreObject* self, PyObject* args) {
  PyObject* ids_list;
  PyObject* slots_obj;
  if (!PyArg_ParseTuple(args, "OO", &ids_list, &slots_obj)) return nullptr;
  std::vector<const char*> ids;
  if (!seq_ids_from_list(ids_list, &ids)) return nullptr;
  Py_buffer view;
  if (!i32_buffer(slots_obj, &view,
                  static_cast<Py_ssize_t>(ids.size())))
    return nullptr;
  int64_t r = self->bm->charge_decode(
      ids.data(), static_cast<int64_t>(ids.size()),
      static_cast<int32_t*>(view.buf));
  PyBuffer_Release(&view);
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, "unknown sequence in charge_decode");
    return nullptr;
  }
  if (r == -1) {
    // duplicate-id batch defeated the pre-count: same MemoryError the
    // Python manager's append_slot raises mid-batch
    PyErr_SetString(PyExc_MemoryError, "out of KV blocks on append");
    return nullptr;
  }
  return PyLong_FromLongLong(r);
}

PyObject* core_fill_block_tables(CoreObject* self, PyObject* args) {
  PyObject* ids_list;
  PyObject* tables_obj;
  if (!PyArg_ParseTuple(args, "OO", &ids_list, &tables_obj)) return nullptr;
  std::vector<const char*> ids;
  if (!seq_ids_from_list(ids_list, &ids)) return nullptr;
  Py_buffer view;
  if (PyObject_GetBuffer(tables_obj, &view,
                         PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE
                         | PyBUF_STRIDES) != 0)
    return nullptr;
  if (view.itemsize != 4 || view.ndim != 2
      || view.shape[0] < static_cast<Py_ssize_t>(ids.size())) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_TypeError,
                    "expected a 2-D C-contiguous int32 buffer with a row "
                    "per sequence");
    return nullptr;
  }
  int64_t stride = static_cast<int64_t>(view.shape[1]);
  int64_t r = self->bm->fill_block_tables(
      ids.data(), static_cast<int64_t>(ids.size()),
      static_cast<int32_t*>(view.buf), stride);
  PyBuffer_Release(&view);
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, "unknown sequence in fill_block_tables");
    return nullptr;
  }
  if (r > stride) {
    PyErr_SetString(PyExc_ValueError,
                    "block table longer than the buffer row");
    return nullptr;
  }
  return PyLong_FromLongLong(r);
}

PyObject* core_reserve_batch(CoreObject* self, PyObject* args) {
  PyObject* ids_list;
  PyObject* totals_list;
  if (!PyArg_ParseTuple(args, "OO", &ids_list, &totals_list)) return nullptr;
  std::vector<const char*> ids;
  if (!seq_ids_from_list(ids_list, &ids)) return nullptr;
  if (!PyList_Check(totals_list)
      || PyList_GET_SIZE(totals_list)
         != static_cast<Py_ssize_t>(ids.size())) {
    PyErr_SetString(PyExc_TypeError, "totals must be a list matching "
                                     "seq_ids");
    return nullptr;
  }
  std::vector<int64_t> totals(ids.size());
  for (Py_ssize_t i = 0; i < static_cast<Py_ssize_t>(ids.size()); ++i) {
    long long v = PyLong_AsLongLong(PyList_GET_ITEM(totals_list, i));
    if (v == -1 && PyErr_Occurred()) return nullptr;
    totals[static_cast<size_t>(i)] = v;
  }
  int64_t r = self->bm->reserve_batch(
      ids.data(), static_cast<int64_t>(ids.size()), totals.data());
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, "unknown sequence in reserve_batch");
    return nullptr;
  }
  return PyBool_FromLong(r == 0);
}

PyObject* core_advance_batch(CoreObject* self, PyObject* args) {
  PyObject* ids_list;
  long long steps;
  if (!PyArg_ParseTuple(args, "OL", &ids_list, &steps)) return nullptr;
  std::vector<const char*> ids;
  if (!seq_ids_from_list(ids_list, &ids)) return nullptr;
  int64_t r = self->bm->advance_batch(
      ids.data(), static_cast<int64_t>(ids.size()), steps);
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, "unknown sequence in advance_batch");
    return nullptr;
  }
  if (r == -3) {
    PyErr_SetString(PyExc_ValueError, "advance beyond reserved capacity");
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* core_admit_prefill(CoreObject* self, PyObject* args) {
  PyObject* counts_list;
  long long max_seats, max_prefill_tokens;
  int min_bucket;
  if (!PyArg_ParseTuple(args, "OLLi", &counts_list, &max_seats,
                        &max_prefill_tokens, &min_bucket))
    return nullptr;
  std::vector<int32_t> counts;
  if (!tokens_from_list(counts_list, &counts)) return nullptr;
  int64_t picked = 0, bucket = 0;
  self->bm->admit_prefill(counts.data(),
                          static_cast<int64_t>(counts.size()), max_seats,
                          max_prefill_tokens, min_bucket, &picked, &bucket);
  return Py_BuildValue("LL", static_cast<long long>(picked),
                       static_cast<long long>(bucket));
}

PyObject* core_release_out_of_window(CoreObject* self, PyObject* args) {
  const char* seq_id;
  long long first_needed;
  if (!PyArg_ParseTuple(args, "sL", &seq_id, &first_needed)) return nullptr;
  int64_t r = self->bm->release_out_of_window(seq_id, first_needed);
  if (r == -2) {
    PyErr_SetString(PyExc_KeyError, seq_id);
    return nullptr;
  }
  return PyLong_FromLongLong(r);
}

PyMethodDef core_methods[] = {
    {"num_free_blocks", (PyCFunction)core_num_free_blocks, METH_NOARGS, ""},
    {"num_seqs", (PyCFunction)core_num_seqs, METH_NOARGS, ""},
    {"blocks_needed", (PyCFunction)core_blocks_needed, METH_O, ""},
    {"can_allocate", (PyCFunction)core_can_allocate, METH_O, ""},
    {"prefix_hits", (PyCFunction)core_prefix_hits, METH_NOARGS, ""},
    {"prefix_queries", (PyCFunction)core_prefix_queries, METH_NOARGS, ""},
    {"lookup_prefix", (PyCFunction)core_lookup_prefix, METH_VARARGS, ""},
    {"prefix_chain", (PyCFunction)core_prefix_chain, METH_O, ""},
    {"prefix_resolvable", (PyCFunction)core_prefix_resolvable, METH_O, ""},
    {"num_cached_blocks", (PyCFunction)core_num_cached_blocks, METH_NOARGS,
     ""},
    {"num_restoring_blocks", (PyCFunction)core_num_restoring_blocks,
     METH_NOARGS, ""},
    {"set_record_evictions", (PyCFunction)core_set_record_evictions, METH_O,
     ""},
    {"take_evictions", (PyCFunction)core_take_evictions, METH_NOARGS, ""},
    {"begin_restore", (PyCFunction)core_begin_restore, METH_O, ""},
    {"commit_restore", (PyCFunction)core_commit_restore, METH_VARARGS, ""},
    {"abort_restore", (PyCFunction)core_abort_restore, METH_O, ""},
    {"allocate", (PyCFunction)core_allocate, METH_VARARGS, ""},
    {"needs_new_block", (PyCFunction)core_needs_new_block, METH_O, ""},
    {"can_append", (PyCFunction)core_can_append, METH_O, ""},
    {"append_slot", (PyCFunction)core_append_slot, METH_O, ""},
    {"reserve", (PyCFunction)core_reserve, METH_VARARGS, ""},
    {"advance", (PyCFunction)core_advance, METH_VARARGS, ""},
    {"slot_for_token", (PyCFunction)core_slot_for_token, METH_VARARGS, ""},
    {"block_table", (PyCFunction)core_block_table, METH_O, ""},
    {"free", (PyCFunction)core_free, METH_VARARGS, ""},
    {"decode_shortfall", (PyCFunction)core_decode_shortfall, METH_O, ""},
    {"charge_decode", (PyCFunction)core_charge_decode, METH_VARARGS, ""},
    {"fill_block_tables", (PyCFunction)core_fill_block_tables, METH_VARARGS,
     ""},
    {"reserve_batch", (PyCFunction)core_reserve_batch, METH_VARARGS, ""},
    {"advance_batch", (PyCFunction)core_advance_batch, METH_VARARGS, ""},
    {"admit_prefill", (PyCFunction)core_admit_prefill, METH_VARARGS, ""},
    {"release_out_of_window", (PyCFunction)core_release_out_of_window,
     METH_VARARGS, ""},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject CoreType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// ngram_propose: n-gram prompt-lookup draft proposal for speculative
// decoding.  Exact port of tpuserve_torch/runtime/spec.py:ngram_propose — the
// proposer runs on the synchronous host hot path once per sequence per
// spec step (a batch of 64 scans up to 64 x 1024 tokens between device
// dispatches), which is worth native speed.
// ---------------------------------------------------------------------------

PyObject* py_ngram_propose(PyObject* /*self*/, PyObject* args,
                           PyObject* kwds) {
  PyObject* ids_list;
  int k, max_ngram = 3, min_ngram = 1, max_lookback = 1024;
  static const char* kwlist[] = {"ids", "k", "max_ngram", "min_ngram",
                                 "max_lookback", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "Oi|iii",
                                   const_cast<char**>(kwlist), &ids_list,
                                   &k, &max_ngram, &min_ngram,
                                   &max_lookback))
    return nullptr;
  if (!PyList_Check(ids_list)) {
    PyErr_SetString(PyExc_TypeError, "expected a list of ints");
    return nullptr;
  }
  // Convert only the trailing lookback window: the caller passes the FULL
  // sequence (possibly tens of thousands of tokens) and converting it all
  // would put the O(context) cost right back on the host hot path.
  Py_ssize_t total = PyList_GET_SIZE(ids_list);
  Py_ssize_t start_i = 0;
  if (max_lookback > 0 && total > static_cast<Py_ssize_t>(max_lookback))
    start_i = total - static_cast<Py_ssize_t>(max_lookback);
  std::vector<int32_t> ids(static_cast<size_t>(total - start_i));
  for (Py_ssize_t i = start_i; i < total; ++i) {
    long val = PyLong_AsLong(PyList_GET_ITEM(ids_list, i));
    if (val == -1 && PyErr_Occurred()) return nullptr;
    ids[static_cast<size_t>(i - start_i)] = static_cast<int32_t>(val);
  }
  const int32_t* v = ids.data();
  const int64_t L = static_cast<int64_t>(ids.size());
  for (int n = max_ngram; n >= min_ngram; --n) {
    if (L < n + 1) continue;
    const int32_t* tail = v + (L - n);
    // most recent occurrence strictly before the trailing one, with at
    // least one continuation token available
    for (int64_t j = L - n - 1; j >= 0; --j) {
      bool match = true;
      for (int t = 0; t < n; ++t) {
        if (v[j + t] != tail[t]) { match = false; break; }
      }
      if (!match) continue;
      int64_t cstart = j + n;
      int64_t clen = L - cstart;
      if (clen > k) clen = k;
      if (clen <= 0) continue;
      return list_from_blocks(v + cstart, clen);
    }
  }
  return PyList_New(0);
}

PyMethodDef module_methods[] = {
    {"ngram_propose", (PyCFunction)py_ngram_propose,
     METH_VARARGS | METH_KEYWORDS,
     "n-gram prompt-lookup draft proposal (native port of "
     "runtime/spec.py:ngram_propose)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "_tpuserve_torch_native",
    "Native runtime components for tpuserve", -1,
    module_methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__tpuserve_torch_native() {
  CoreType.tp_name = "_tpuserve_torch_native.BlockManagerCore";
  CoreType.tp_basicsize = sizeof(CoreObject);
  CoreType.tp_flags = Py_TPFLAGS_DEFAULT;
  CoreType.tp_new = PyType_GenericNew;
  CoreType.tp_init = (initproc)core_init;
  CoreType.tp_dealloc = (destructor)core_dealloc;
  CoreType.tp_methods = core_methods;
  if (PyType_Ready(&CoreType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&module_def);
  if (!m) return nullptr;
  Py_INCREF(&CoreType);
  if (PyModule_AddObject(m, "BlockManagerCore",
                         reinterpret_cast<PyObject*>(&CoreType)) < 0) {
    Py_DECREF(&CoreType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
